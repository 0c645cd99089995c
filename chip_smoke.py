#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero):

1. env      torch/CUDA versions and the card's name and power limit.
2. build    nvcc builds of the fourteen kernel libraries for sm_90a, in
            parallel (the GEMM's two routes are a library each; each
            tunable kernel's launch variants other than the default are a
            ``*_variants`` library beside it; the decode library's seven
            translation units compile at once, then link), with each
            library's seconds.
3. kernel   each kernel against its plain version at gpt2-124m's,
            qwen3-1.7b's, deepseek-moe-16b's and jamba-1.5-large-398b's
            attention shapes (12 heads of 64; 8 KV heads of 128, 2 query
            heads each; 16 heads of 128; 8 KV heads of 128, 8 query heads
            each), in bf16 and f32: the paged
            flash-decode on shuffled block tables with ragged lengths; the
            chunked prefill (commit + causal attention) with ragged
            q_start and q_len (0, 1 and the whole chunk), pools compared
            through the tables and blocks no table names left untouched.
            Then the same two kernels on int8 pools (per-row fp32 scales)
            and on bf16 pools under an f32 q, at every head shape (D 16,
            32, 64, 128): outputs within tolerance, committed codes, rows
            and scales bit-equal through the tables, unnamed blocks and
            scales untouched, and rows and scales past each slot's length
            poisoned (codes +-127, scales 1e4 / NaN) without effect.
            The quantized cases are held per element to 1e-5 plus one ulp
            of a bf16 output (``decode_close``).  Then timings at the
            serve phases' shapes (median of CUDA-event timings) beside
            each kernel's bound, a library yardstick and, for the decode
            and the prefill, the host's time of one wrapper call: bf16
            pools, then int8 pools beside the same-shape bf16 call, and
            the commit kernel alone at a decode step's shapes into bf16
            pools (beside the two ``index_put_`` calls that write the same
            rows) and int8 pools.  Then the decode launch that commits
            each slot's new row itself (``k_new``/``v_new``): bit-equal to
            the commit kernel then the decode (output, pools, scales) for
            every (q, pool) pair at every head shape and at the serve
            shapes, and its head slices given the rows' amax; timed at
            qwen3-1.7b's serve shapes (bf16 and int8 pools), gpt2-124m's,
            deepseek-moe-16b's and jamba-1.5-large-398b's (with the
            prefill) beside its bound,
            the plain versions, the two-launch pair
            (device ms and a decode layer's host us) and, for bf16, two
            ``index_put_`` and SDPA.
   kernel-sharded  kernel 2.4, the head-sharded decode: for every (q,
            pool) pair at every head shape, the slices (i, n), n in 1, 2,
            4, concatenated, bit-equal to the unsharded launch and each
            within ``decode_close`` of its plain version; the int8 commit
            given each row's amax bit-equal to the unsharded commit's head
            slice; the validation errors; then the n = 2 slice timed at
            qwen3-1.7b's and jamba-1.5-large-398b's serve shapes beside
            the unsharded launch.
   kernel-hpc  the STREAM, Jacobi2D, GEMM and SpMV kernels against their
            plain versions: odd, misaligned and edge shapes, fp32/bf16
            (and fp16 for STREAM), SpMV rows of 0, 1 and 128 nonzeros; each
            GEMM case on the route the rule names (``GEMM_CASES``: bf16
            that TMA can address on wgmma, with M and N past whole tiles,
            K = 8, K % 64 != 0 and a shape inside one tile; the rest on
            simt), by the route counters; SpMV also at widths 1 to 256,
            row_nnz of 0, negative and past the width, and on misaligned
            inputs, each on the instantiation ``spmv_plan`` names.
   timing   the four at full size (STREAM 2^21 x 128 fp32, GEMM 8192^3
            fp32 on the simt route and bf16 on the wgmma route, Jacobi2D
            16384^2 fp32, SpMV 2^20 rows of block-ELL width 128, Zipf nnz
            up to 64): kernel, plain and library ms beside the least time
            at the H100's peaks for the dtype (SpMV's library call,
            ``torch.sparse.mm``, on a CSR of each workload's own matrix:
            the live lanes, or every lane of the fixed width); SpMV beside its plan, its
            gathers a call and the gather floor (the kernel's gathers
            alone, ``spmv_gather_probe``).
   kernel-dense  the RX gate (n 6, 12, 22; qubits 0, 1, 4, 5, n-1; theta
            0.25, 1.1, 2 pi) bit-equal to its plain version, and the
            contiguous flash-decode (D 16/32/64/128, G 1/2/4/8, ragged
            lengths 0, 1 and S, K/V past them poisoned with 1e4/NaN)
            against its plain version, both in fp32 and bf16; the paged
            kernels of phase 3 also run at D 16 and 32.
   timing-dense  the RX gate at 28 qubits on qubits 0, 5, 13 and 27, the RX
            layer at 21 and 28 qubits, and the contiguous flash-decode
            (bf16, 32 slots of 4096 rows, gpt2-124m and qwen3-1.7b heads,
            lengths ragged in [1, S] and all S) with the same columns.
   analysis the paper's method through ``AnalysisService`` over those
            workloads (the GEMM in fp32 and in bf16, so on both routes),
            the RX layer at 28 qubits, the flash-decode at full size and
            the registry's qc-gate, flash-decode and flash-prefill
            workloads, on the h100 and grace-core models, ROIs timed on the
            card: every kernel of the suite launches, and no roofline share
            is above 1.05.
   analysis-compiled  the compiled event source through the same service:
            the registry's seven kernel workloads and the five
            ``vectorization_report`` workloads on the h100 and grace-core
            models, ``source="compiled"``, ROIs timed on the card, over a
            fresh store directory: no error, one recording a workload (12
            for 24 cells), every kernel of the registry workloads launched
            in the timed ROIs, the example workloads' classes those the
            CPU tests pin; then a second drain through the service CLI in
            a subprocess on the same directory: no recording, 12 store
            hits, every result equal to the first drain's but ``wall_s``.
   suite    the paper's 13 apps (``repro_torch.suite.apps``) at the
            reference's sizes, each analysed on grace-core and h100 with
            its ROI timed on the card: the RX gate (kernel 2.9) launched 16
            times a QC layer and no other kernel of the suite (the other
            apps run torch ops); each app's output on the card against the
            CPU's from the same inputs within the CPU tests' bounds; the
            apps the paper sizes at those sizes (QC 21 qubits, 21
            launches, the state against 21 plain passes on the card;
            STREAM 1024 MB; DGEMM/SGEMM 12288^2; Jacobi2D 16384^2; the LLM
            apps at gpt2-124m FULL; YOLOv3 608^2), each by ``measure``
            (best of at least 5) with its AI and H100 roofline share; the
            driver (``python -m repro_torch.suite.run``'s ``main``) in
            process: Fig. 3 and Table 3 with ``--device cuda --chip h100
            --record`` into a temporary ledger, its CSVs, ``summary.json``
            with the card's ``nvidia-smi`` line, and Table 3 equal to the
            CPU's (``AGREEMENT 13/13``).
   quickstart  ``repro_torch.examples.quickstart`` twice over a fresh
            store: finite losses, the train step recorded once, then 0
            recordings and a store hit.
   tuning   the roofline-guided autotuner (``repro_torch.tuning``) over
            the tunable kernels' launch variants: every candidate of every
            space (the GEMM's two routes, the four STREAM ops, Jacobi2D,
            the RX gate, the contiguous flash-decode's splits, the
            prefill's tiles) launched once at the registry's example
            problem in each of its space's dtypes and held against its
            plain version with that kernel's own tolerance (the decode
            also at a cache of twice its largest split, the prefill also
            at qwen3's heads and block size), each wrapper's
            ``variant_launches`` showing every variant; then ``python -m
            repro_torch.tuning --dtypes space --keep 2`` twice in
            subprocesses over a fresh ``$REPRO_ARTIFACT_DIR`` (11 records,
            then the same 11 cached with 0 timing runs); in this process
            ``load_tuned`` of every tunable kernel from that store,
            ``analyze("kernel/gemm", h100).tuning["record"]`` equal to the
            stored config, ``GEMM.kernel`` launching it, a non-empty
            ``tuned_state_hash()``, then every config cleared; last, one
            tune with every candidate timed at each full-size problem
            (GEMM 8192^3 bf16 and fp32, flash-decode B32 S4096 qwen3
            heads bf16, the prefill at qwen3's serve shapes, STREAM triad
            2^21 x 128, Jacobi2D 16384^2, the RX gate at 28 qubits), each
            candidate first held against the plain version on the same
            full-size inputs, then its device ms beside the default's.
4. serve    ``repro_torch.launch.serve`` at the full width of gpt2-124m
            (bf16): every request completes, and the decode kernel runs 12
            times (once per attention layer) per fused step, each launch
            committing
            the step's rows (the commit kernel never runs alone
            unsharded).
   profile  a second, shorter drain of that engine under torch.profiler:
            the device's busy time by kernel (the top ten, and sums for the
            prefill attention, the decode attention, the commit and the
            rest) against the wall time.
5. serve-chunked  the same CLI at the full width of qwen3-1.7b (bf16, all
            28 layers) with chunked prefill: every request completes, and
            the decode and prefill kernels together run 28 times per fused
            step, each at least once, every decode launch committing.
   profile  the same profile over a second drain of that engine.
   serve-shared-int8  the same CLI at qwen3-1.7b's full width with int8 KV
            pools and a shared 256-token prompt prefix (prompts 64..256
            after it), with ``--share-prefixes`` and then without, on the
            same weights: every request completes, the streams are equal,
            sharing stores fewer physical blocks (dedup ratio > 1), the
            int8 kernels launch 28 times a fused step (every decode launch
            committing); then two identical prompts copy on write at their
            first generated token with the unshared streams.  Prints the
            int8 pool bytes beside a bf16 pool's for the same blocks, and
            the phase's seconds.
   serve-smoke  ``python -m repro_torch.launch.serve`` with its defaults
            (gpt2-124m smoke, head dim 16, f32) on the card: its greedy
            streams equal the same command's with ``--device cpu``.
   serve-spec  speculative decoding through the serve CLI's path, token
            by token with a gpt2-124m draft proposing 4 tokens a slot, on
            the gpt2 serve traffic: a qwen3-1.7b target (28 layers, the
            weights of serve-chunked; another model, so most proposals
            miss) and gpt2-124m self-speculation (the weights of serve).
            Every request completes; every target step runs kernel 2.2 at
            width 5 (a verification) or 2.1 (a decode step, committing) on
            each attention layer, every draft step 2.2 at width 1 on each
            of the draft's, and no other width runs (the wrapper counts
            launches by width); prints tok/s, steps, acceptance and the
            launches a step.  Kernel 2.2 is timed at those widths (gpt2
            heads at 1 and 5, qwen3's at 5; 8 slots of 256 tokens) beside
            its bound in the kernel phase.
   serve-sampled  gpt2-124m sampled (T 0.8, top-k 50, seed 7) through the
            CLI twice on serve's weights: equal streams, not the greedy
            ones; then the sampler on (8, 5, 151936) random logits on the
            card against the CPU: threefry keys and uniforms bit-equal,
            token mismatches only at near ties (gap under 1e-5).
   scenario  the port's scenario runner (``run_cell``, twins included)
            at full width in bf16 on serve's and serve-chunked's weights:
            gpt2-124m under both schedulers and every fault plan (7
            cells: Poisson 0.5 arrivals, prompts 4..64, early stop 0.1, 16
            requests of up to 32 tokens, 8 slots), and one qwen3-1.7b cell
            chunked by 64 (budget 256) and preempted (8 requests, prompts
            64..256, 16 tokens).  Every cell serves every request within
            its default SLOs; preempt cells preempt, device-loss cells
            restart, malformed cells reject the two injected uids; the
            gpt2 cells equal their twins exactly, the qwen3 cell its fault
            twin and token-by-token twin up to bf16 near ties; 2.1 runs
            in the continuous cells, 2.3 in the wave cells, 2.2 in the
            qwen3 cell.  Prints each cell's tok/s, steps, preemptions,
            restarts, rejections, twin verdict, launches and seconds.
   parity-scenario  the smoke matrix's 7 gpt2-124m cells and its 7
            qwen3-1.7b cells on the card and on the CPU with the same f32
            smoke weights: every cell ok on both, and the card's streams
            the CPU's up to near ties.
   perf-ledger  the perf ledger (``repro_torch.perf``) in a fresh
            ``$REPRO_ARTIFACT_DIR``: the default serve command with
            ``--record`` twice on the card and once with ``--device cpu``
            (two runs in series h100/fp32, one in grace-core/fp32; the
            exact counters equal across all three; ``env.gpu`` the
            ``nvidia-smi`` line; kernel 2.1 once a layer a step); ``python
            -m repro_torch.perf gate`` on the second card run against the
            first with no counter regressed (its exit code and its tok/s
            and latency deltas printed, not judged); the scenario phase's
            8 cells recorded through ``record_cell`` twice, each second
            record gating clean; the analysis phase's report recorded and
            re-triaged: the Fig. 8 class of every ``@h100`` row equals the
            one the report printed.  Prints the phase's seconds.
6. parity   GPU and CPU engines must give the same greedy streams: gpt2-124m
            at full width token by token, and qwen3-1.7b at full width cut
            to 4 layers, chunked on the card, chunked on the CPU and token
            by token on the card, all in float32.
   parity-spec  speculative decoding in float32, qwen3-1.7b and
            mamba2-370m at full width cut to 4 layers with a 4-layer
            gpt2-124m draft: the card's speculative streams against the
            CPU's and the card's non-speculative ones, greedy and (mamba2,
            whose rejections restore and replay its states) sampled, up to
            near ties; drafted and accepted counts equal card and CPU.
   parity-int8  qwen3-1.7b at full width cut to 4 layers, float32, int8
            pools: teacher-forced logits on the card within 0.03 of the
            CPU's, and within the reference's qwen3 int8 budget (0.11) of
            the card's f32 cache; the card's int8 run launches the decode
            (committing) and prefill kernels on int8 pools.
   serve-moe  the serve CLI's traffic at the full width of
            deepseek-moe-16b (bf16) cut to ``MOE_SERVE_LAYERS`` layers (its
            dense first layer, then 3 MoE layers of 64 experts, top 6, and 2
            shared experts) with chunked prefill: every request completes,
            the decode and prefill kernels together run 4 times per fused
            step, each at least once, every decode launch committing;
            prints the cut, the parameter draw's seconds and the peak of
            allocated memory.
   profile-moe  the profile of a second drain of that engine, then a
            third under host and device tracing with the MoE functions
            wrapped in ranges: device time by group (expert products;
            routing, dispatch and combine; the shared expert; attention;
            the rest), and a decode step's device time beside its bytes
            bound.
   parity-moe  deepseek-moe-16b at full width cut to 3 layers (the dense
            first layer and two MoE layers), float32: chunked on the card,
            chunked on the CPU and token by token on the card give the
            same greedy streams, up to near ties.
   serve-mla  the serve CLI's traffic at deepseek-v2-lite-16b's full
            width (bf16) cut to ``MLA_SERVE_LAYERS`` layers (every one MLA
            over latent pools of 512 + 64 elements a row: a dense first
            layer, then 8 MoE layers of 64 experts, top 6, and 2 shared)
            with ``CHUNKED_ARGV``'s traffic: every request completes and no
            flash kernel launches (MLA attends in torch ops); prints the
            cut, the draw's seconds, parameter bytes, the latent pools' bytes
            beside GQA pools' for the same blocks, peak allocated memory,
            steps and tok/s.
   profile-mla  the device-only profile of a second drain, then device
            time by group (MLA attention: projections, latent gather,
            absorbed scores and context, commit; the MoE groups; the rest)
            and a decode step beside its bytes bound (the weights and the
            latent pools read).
   parity-mla  deepseek-v2-lite-16b at full width cut to 3 layers (the
            dense first layer and two MoE layers), float32: chunked on the
            card, chunked on the CPU and token by token on the card give
            the same greedy streams, up to near ties, on f32 and on int8
            latent pools.
   serve-mamba2  the serve CLI's traffic at mamba2-370m's full width
            (bf16) cut to 12 of its 48 Mamba-2 layers with
            ``CHUNKED_ARGV``'s traffic: every request completes and no
            attention or commit kernel launches; prints the cut, the
            steps, tok/s, peak allocated memory and the phase's seconds.
   profile-mamba2  the device-only profile of a second drain (kernels a
            step, the idle share), then a third under host and device
            tracing: device time of the mamba mixers and of the rest, and
            a decode step's device time beside its bytes bound (the
            parameters, and the 8 slots' fp32 states read and written).
   parity-mamba2  mamba2-370m at full width and depth, float32: chunked
            on the card, chunked on the CPU and token by token on the card
            give the same greedy streams, up to near ties.
7. serve-mesh  tensor-parallel serving: ``CHUNKED_ARGV``'s first 8
            requests with ``--mesh 1x2`` and ``--mesh 2x2`` (qwen3-1.7b,
            full width, 28 layers, bf16), as ranks sharing the card over
            gloo (NCCL refuses two ranks on one device), the ranks cutting
            their shards from serve-chunked's weights (CUDA IPC): every
            request completes, and on every
            rank the head-sharded decode (kernel 2.4) launches once per
            layer per decode step over KV / M heads, committing its slots'
            rows, and with two data ranks the commit kernel writes the
            other rank's rows once per layer and fused step; per rank the
            launches, backend, collectives a step, bytes staged through
            the host, wall time and tok/s, and how many streams equal the
            unsharded card engine's on the same requests.
   parity-mesh  the port's mesh check in float32 (gpt2-124m full width,
            qwen3-1.7b full width cut to 4 layers, mamba2-370m full width
            cut to 4 layers, deepseek-moe-16b full width cut to 3 layers,
            32 of its 64 experts a rank on a model axis of 2,
            deepseek-v2-lite-16b and jamba-1.5-large-398b at their smoke
            shapes, gpt2-124m with int8
            pools and prefix sharing, gpt2-124m self-speculating with k 2;
            3 requests of 8 tokens on 2 slots)
            on 1x1, 2x1, 1x2 and 2x2 against the
            unsharded card engine: equal greedy streams, and int8 pools
            within the check's rule.
8. serve-jamba  last, with every earlier engine and weight freed: one
            jamba-1.5-large-398b superblock at full width (7 Mamba-2
            layers of 256 SSM heads, an attention layer of 64 heads over 8
            KV heads of 128, MoE on the odd layers) with its routed
            experts cut from 16 to 4 (16.2 B parameters, 32.3 GB in bf16),
            serving ``CHUNKED_ARGV``'s traffic: every request completes,
            the decode and prefill kernels together launch once per fused
            step, each at least once, every decode launch committing;
            prints the draw's seconds, peak allocated memory, steps, tok/s
            and the phase's seconds.
   profile-jamba  as profile-moe: the device-only profile, then device
            time by group (expert products; routing, dispatch and combine;
            the mamba mixers; attention; the rest) and a decode step
            beside its bytes bound.
   parity-jamba  one superblock at jamba's full mixer widths, float32,
            all 16 experts, top 2, ``d_ff`` and ``d_ff_expert`` cut to
            1024 (5.79 B parameters, drawn on the card and copied to the
            CPU): chunked on the card, chunked on the CPU and token by
            token on the card give the same greedy streams, up to near
            ties.
9. train    last, on a card with nothing else held: the port's train
            stack (``repro_torch.launch.train.train``) at qwen3-1.7b's
            full width (28 layers, 2.03 B parameters, bf16 params with an
            fp32 master and moments, fp32 logits of 151,936 columns), 6
            steps of 4 x 2048 tokens, every layer recomputed in the
            backward pass, no checkpoint: a finite loss and grad norm at
            every step, every leaf of the master moved, the peak of
            allocated memory under the card's and no kernel of phases 3-5
            launched (the train path reaches none).  Prints the step's ms
            and tokens/s, 6 N T over the step time as a share of the bf16
            peak, the peak memory, the card's ``nvidia-smi`` line, and for
            the last two steps under ``torch.profiler`` kernels a step and
            the device's idle share over their interval.
   train-resume  gpt2-124m at full width (8 x 512 tokens, 6 steps)
            through the resilient loop over a checkpoint store, a
            checkpoint every 3 steps and one injected device loss before
            step 4, against the same job without a fault or a store: one
            restart, final params and optimizer state bit-equal (or,
            where the card's step is not bit-for-bit repeatable, within
            parity-train's bounds, with the aten ops named that may add
            with atomics), and the faulted run's peak of allocated memory
            at most 1.2 times the clean run's.
   parity-train  one train step of each of the eleven archs' smoke
            configs (f32, TF32 off; whisper's encoder-decoder included)
            on the card against the CPU from the
            same weights and batch: the loss at rtol 1e-5, every gradient
            and the params after the step at rtol 1e-4 and atol 1e-5, the
            moments m and v at those bounds carried through their update;
            the card's update against AdamW replayed on the CPU from the
            card's gradients, within a tenth of the step's lr; per arch
            whether the card's gradients repeat bit for bit, and the
            step's aten ops that may add with atomics.
10. whisper-train  train's job on whisper-large-v3 at full width (32
            encoder and 32 decoder layers, 2.02 B parameters): 4 steps of
            4 x 2048 decoder tokens over 512 post-conv frames a row, remat
            full, the last under the profiler; train's checks, and ``6
            (N_enc F + N_dec T)`` over the step time as a share of the
            bf16 peak (the formula printed).
   whisper-decode  whisper-large-v3 at full width in bf16 through the
            step functions: 8 slots over 1500 frames each, a 4-token
            prompt prefilled into a 448-row cache, 127 greedy decode
            steps; kernel 2.3 twice a decoder layer a step (the
            self-attention over the cache, the cross-attention over the
            1500 encoder rows) and no other serve kernel, finite logits,
            the step logits over the first 16 tokens within 5% of the
            teacher-forced forward's largest, and its argmax wherever no
            such difference can flip it; prints prefill ms, decode step
            ms, tokens/s, the cross K/V's bytes, whether two runs give
            equal streams, and profiles of 8 steps and of the prefill.
            Kernel 2.3 is timed at these shapes (``timing-whisper``) in
            the kernel phase.
   parity-whisper  the smoke config in f32, card against CPU from the
            same weights: the forward's, the prefill's and 16 decode
            steps' logits at rtol 1e-4 and atol 1e-5, equal greedy
            streams, and kernel 2.3 launched twice a layer a step.

Each phase line also goes to stderr as one short line.  ``WATCHDOG_S``
seconds after its start the script stops itself: every thread's stack and
the last phase go to stderr, the processes it started are killed, and it
exits with 3.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
``{"ok": true, "device": ...}`` line.  Without CUDA, or outside a checkout,
it prints no result and exits 1.  It imports nothing of JAX and nothing of
the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: the H100 ChipSpec's peak key of each torch dtype name
PEAK_KEY = {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16"}

ARCH_HEADS = {"gpt2-124m": (12, 1, 64), "qwen3-1.7b": (8, 2, 128),
              "deepseek-moe-16b": (16, 1, 128),
              "jamba-1.5-large-398b": (8, 8, 128)}
#: the smoke configs' heads (head dim 16), the registry's flash workloads'
#: heads (16 with 4 query heads a KV head) and a head dim of 32, checked on
#: the paged kernels beside the full widths
SMALL_HEADS = {"gpt2-124m smoke": (4, 1, 16), "qwen3-1.7b smoke": (2, 2, 16),
               "kernel/flash-* workloads": (2, 4, 16),
               "head dim 32": (4, 2, 32)}
KERNEL_B, KERNEL_BS, KERNEL_NB = 32, 16, 256
PREFILL_B, PREFILL_C, PREFILL_NB = 8, 64, 64
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-5}

SERVE_ARGV = ["--arch", "gpt2-124m", "--no-smoke", "--max-batch", "8",
              "--max-len", "256", "--requests", "16", "--prompt-hi", "64",
              "--max-new", "32", "--device", "cuda"]
CHUNKED_ARGV = ["--arch", "qwen3-1.7b", "--no-smoke", "--max-batch", "8",
                "--max-len", "1024", "--block-size", "16", "--requests", "16",
                "--prompt-lo", "64", "--prompt-hi", "512", "--max-new", "32",
                "--prefill-chunk", "64", "--prefill-budget", "256",
                "--device", "cuda"]
SHARED_ARGV = ["--arch", "qwen3-1.7b", "--no-smoke", "--max-batch", "8",
               "--max-len", "1024", "--block-size", "16", "--requests", "16",
               "--prompt-lo", "64", "--prompt-hi", "256", "--max-new", "32",
               "--prefill-chunk", "64", "--prefill-budget", "256",
               "--kv-dtype", "int8", "--shared-prefix-len", "256",
               "--device", "cuda"]
MOE_ARGV = ["--arch", "deepseek-moe-16b", "--no-smoke", "--max-batch", "8",
            "--max-len", "1024", "--block-size", "16", "--requests", "16",
            "--prompt-lo", "64", "--prompt-hi", "512", "--max-new", "32",
            "--prefill-chunk", "64", "--prefill-budget", "256",
            "--device", "cuda"]
#: the chunked serve phases' traffic on mamba2-370m, jamba-1.5-large-398b
#: and deepseek-v2-lite-16b
MAMBA_ARGV = ["mamba2-370m" if a == "qwen3-1.7b" else a for a in CHUNKED_ARGV]
JAMBA_ARGV = ["jamba-1.5-large-398b" if a == "qwen3-1.7b" else a
              for a in CHUNKED_ARGV]
MLA_ARGV = ["deepseek-v2-lite-16b" if a == "qwen3-1.7b" else a
            for a in CHUNKED_ARGV]
#: deepseek-moe-16b's depth in serve-moe: its dense first layer and three
#: MoE layers keep kernels 2.1/2.2 at its shapes on a serve path, and the
#: same 64-expert MoE FFN runs in serve-mla's eight MoE layers
MOE_SERVE_LAYERS = 4
#: deepseek-v2-lite-16b's depth in serve-mla and profile-mla (of 27: its
#: dense first layer and eight MoE layers; the grouped profile's tracing
#: grows with the depth)
MLA_SERVE_LAYERS = 9
#: deepseek-v2-lite-16b cut to its dense first layer and two MoE layers,
#: the depth of parity-mla
MLA_PARITY_LAYERS = 3
#: mamba2-370m's depth in serve-mamba2 and profile-mamba2 (of 48; its
#: steps are host-bound, about 56 launches a mixer, and the grouped
#: profile's tracing grows with them); parity-mamba2 runs all 48
MAMBA_SERVE_LAYERS = 12
#: deepseek-moe-16b cut to its dense first layer and two MoE layers, the
#: depth of the parity phases' MoE runs
MOE_PARITY_LAYERS = 3
#: jamba's routed experts on the card (one superblock of 16 is 45.1 B
#: parameters, 90.3 GB in bf16; of 4, 16.2 B and 32.3 GB), and its FFN
#: widths in parity-jamba
JAMBA_EXPERTS = 4
JAMBA_PARITY_FF = 1024
#: mamba2-370m's depth in parity-mesh
MAMBA_MESH_LAYERS = 4
PARITY_REQUESTS, PARITY_NEW, PARITY_TOP2_GAP = 4, 8, 1e-3
#: the archs whose smoke-matrix cells parity-scenario runs card against CPU
PARITY_SCENARIO_ARCHS = ("gpt2-124m", "qwen3-1.7b")
#: the reference's teacher-forced budget for qwen3-1.7b int8 pools against
#: its f32 cache
PARITY_INT8_BUDGET = 0.11
#: int8 logits on the card against the CPU's: about twice the 0.0144
#: measured on an H100, and below the 0.085 that int8 is from f32 there
PARITY_INT8_CARD_CPU = 0.03
#: decode_close's tolerance, as printed beside a kernel's error
CLOSE_TOL = "1e-5 abs + 1e-5 rel, + one ulp of a bf16 output"
PROFILE_REQUESTS, PROFILE_NEW = 8, 16
SOURCE_DIR = "src/repro_torch/kernels/flash_decode/csrc/"
TPU_KERNELS = "src/repro/kernels/flash_decode/kernel.py"


#: the script's start on the host's clock: every phase line carries its
#: ``elapsed_s`` since then, so that each phase's seconds can be read off
START = time.time()


#: the script's own time limit, just under the 1200 s it is given, so
#: that a run that would be stopped from outside says where it stood:
#: past it, every thread's stack and the last phase line go to stderr, the
#: processes it started are stopped, and it exits with 3
WATCHDOG_S = 1170
#: the phase of the last phase line printed
LAST_PHASE = ["start"]


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.time() - START}
        LAST_PHASE[0] = obj["phase"]
        # one short line a phase on stderr, so that its tail says how far
        # a run got
        print(f"chip_smoke: {obj['phase']} at {obj['elapsed_s']:.1f} s",
              file=sys.stderr, flush=True)
    print(json.dumps(obj), flush=True)


def start_watchdog(limit: float = WATCHDOG_S) -> None:
    """Stop the script ``limit`` seconds after its start: the stacks of its
    threads are dumped (``faulthandler``, which needs no lock, so a hung
    call shows too), then the processes it started are killed and it exits
    with 3."""
    import faulthandler
    import multiprocessing
    import os
    import threading

    left = max(1.0, limit - (time.time() - START))
    faulthandler.dump_traceback_later(left, exit=False)

    def stop() -> None:
        print(f"chip_smoke: still running {limit} s after its start, after "
              f"the phase line {LAST_PHASE[0]!r}; stopped", file=sys.stderr,
              flush=True)
        for child in multiprocessing.active_children():
            child.kill()
        os._exit(3)

    timer = threading.Timer(left + 2.0, stop)
    timer.daemon = True
    timer.start()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_ms(torch, fn, reps: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn()`` in ms: CUDA events around each call,
    each preceded by a spin of about 1 ms on the card, which keeps it busy
    while the host enqueues the call (tens of us of Python for the
    kernel's wrapper, more for the plain version's dozen ops), so the
    events time the device and not the host.  The L2 stays warm, as in a
    serve step, where the kernel reads K/V rows written just before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, reps: int = 200, rounds: int = 5) -> float:
    """Median host time of one call of ``fn()`` in us: ``reps`` calls
    enqueued back to back on an idle card, over ``rounds`` rounds.  Valid
    while the host is slower than the card, so the queue never fills."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_waits(torch, fn, calls: int = 3) -> list:
    """Where each of ``calls`` calls of ``fn`` makes the host wait for the
    card (torch's sync debug mode), as one list of "file:line" per call.
    A timed call should make none, or the CUDA events take in the host's
    time."""
    import warnings

    waits = []
    for _ in range(calls):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        waits.append([f"{Path(w.filename).name}:{w.lineno}" for w in caught
                      if "synchroniz" in str(w.message)])
    return waits


def bound(terms, dtype_name):
    """(least ms the card could take, "bytes" or "operations") at the
    ``repro_torch.core.hw.H100`` peaks (NVIDIA's data sheet)."""
    from repro_torch.core.hw import H100

    t_bytes = terms["bytes"] / H100.hbm_bw * 1e3
    t_ops = terms["flops"] / H100.peak(PEAK_KEY[dtype_name]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def shuffled_tables(torch, gen, B, nb, n_blocks):
    """(B, nb) int32 tables over a random permutation of blocks 1..,
    leaving the rest of the pool (block 0 included) unnamed."""
    perm = torch.randperm(n_blocks - 1, device="cuda", generator=gen)
    return (perm[: B * nb] + 1).reshape(B, nb).to(torch.int32)


# -- decode kernel ------------------------------------------------------------


def paged_inputs(torch, B, KV, G, D, bs, nb, dtype, valid, seed):
    """Random q and pools, a shuffled block table (block 0 reserved) and
    the given valid lengths, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = 1 + B * nb
    kw = dict(device="cuda", generator=gen)
    q = torch.randn((B, KV, G, D), **kw).to(dtype)
    k_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    v_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    bt = shuffled_tables(torch, gen, B, nb, n_blocks)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, bt, vl


def check_decode(torch, np, kernel, ref):
    B, bs, nb = KERNEL_B, KERNEL_BS, KERNEL_NB
    rng = np.random.default_rng(0)
    valid = rng.integers(1, nb * bs + 1, size=B)
    valid[:4] = (1, bs, bs + 1, nb * bs)  # one row, a block edge, full
    for arch, (KV, G, D) in {**ARCH_HEADS, **SMALL_HEADS}.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = dtype_name(dtype)
            args = paged_inputs(torch, B, KV, G, D, bs, nb, dtype,
                                valid.tolist(), seed=1)
            out = kernel.flash_decode_paged(*args)
            torch.cuda.synchronize()
            want = ref.flash_decode_paged_ref(*args)
            err = (out.float() - want.float()).abs().max().item()
            tol = TOLERANCE[name]
            ok = torch.allclose(out.float(), want.float(), atol=tol,
                                rtol=tol)
            ms = device_ms(torch, lambda: kernel.flash_decode_paged(*args),
                           reps=50)
            bound_ms, bound_by = bound(
                ref.work_terms(args[0], args[1], args[3], valid), name)
            emit({"phase": "kernel", "kernel": "flash_decode_paged",
                  "arch_heads": arch, "dtype": name,
                  "B": B, "KV": KV, "G": G, "D": D, "bs": bs, "nb": nb,
                  "max_abs_err": err, "tol": tol, "ok": bool(ok),
                  "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
            require(ok, f"decode kernel != plain for {arch} {name}: max abs "
                        f"err {err} over tolerance {tol}")


def decode_timing(torch, np, kernel, ref, arch, nb, max_valid, seed):
    """Kernel, plain version and one SDPA call at a serve phase's shapes:
    8 slots, ``nb`` blocks of 16 rows, the arch's heads, bf16, with
    lengths drawn over the serve traffic's live range."""
    import torch.nn.functional as F

    B, bs = 8, 16
    KV, G, D = ARCH_HEADS[arch]
    valid = np.random.default_rng(seed).integers(1, max_valid + 1, size=B)
    args = paged_inputs(torch, B, KV, G, D, bs, nb, torch.bfloat16,
                        valid.tolist(), seed=seed + 1)
    q, k_pool, v_pool, bt, vl = args
    out = kernel.flash_decode_paged(*args)
    want = ref.flash_decode_paged_ref(*args)
    err = (out.float() - want.float()).abs().max().item()
    tol = TOLERANCE["bfloat16"]
    require(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol),
            f"decode kernel != plain at {arch} serve shapes: max abs err "
            f"{err}")

    # yardstick: one SDPA call on K/V gathered and expanded beforehand
    S = nb * bs
    k = k_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    v = v_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qh = q.reshape(B, KV * G, 1, D)
    mask = (torch.arange(S, device="cuda")[None, :] < vl[:, None])
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (library().reshape(out.shape).float()
               - want.float()).abs().max().item()
    require(lib_err <= 2 * tol, f"SDPA yardstick disagrees: {lib_err}")
    bound_ms, bound_by = bound(ref.work_terms(q, k_pool, bt, valid),
                               "bfloat16")
    row = {
        "max_abs_err": err,
        "ms": device_ms(torch, lambda: kernel.flash_decode_paged(*args)),
        "plain_ms": device_ms(torch,
                              lambda: ref.flash_decode_paged_ref(*args)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(torch, library),
        "host_us": host_us(torch, lambda: kernel.flash_decode_paged(*args)),
    }
    emit({"phase": "kernel", "kernel": "flash_decode_paged",
          "shapes": f"serve {arch}", "B": B, "KV": KV, "G": G, "D": D,
          "bs": bs, "nb": nb, "dtype": "bfloat16",
          "plan": kernel.decode_plan(nb * bs, bs, B, KV, G, D)._asdict(),
          "valid_len": valid.tolist(), **row})
    return row


# -- chunked-prefill kernel ---------------------------------------------------


def prefill_inputs(torch, B, C, KV, G, D, bs, nb, dtype, q_start, q_len,
                   seed, spare=2):
    """Random q, chunk K/V and pools with ``spare`` blocks that no table
    names (besides block 0), a shuffled table, and the given q_start and
    q_len, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = 1 + B * nb + spare
    kw = dict(device="cuda", generator=gen)
    q = torch.randn((B, C, KV, G, D), **kw).to(dtype)
    k_new = torch.randn((B, C, KV, D), **kw).to(dtype)
    v_new = torch.randn((B, C, KV, D), **kw).to(dtype)
    k_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    v_pool = torch.randn((n_blocks, bs, KV, D), **kw).to(dtype)
    bt = shuffled_tables(torch, gen, B, nb, n_blocks)
    ints = [torch.tensor(x, dtype=torch.int32, device="cuda")
            for x in (q_start, q_len)]
    return [q, k_new, v_new, k_pool, v_pool, bt] + ints


def run_prefill(torch, fn, args):
    """``fn`` on private copies of the pools: (out, k_pool, v_pool)."""
    kp, vp = args[3].clone(), args[4].clone()
    out = fn(*args[:3], kp, vp, *args[5:])
    torch.cuda.synchronize()
    return out, kp, vp


def check_prefill(torch, np, kernel, ref):
    """The kernel pair against its plain version: output rows below q_len
    within tolerance and zeros past it, pools bit-equal (a commit is a
    copy), and every block no table names byte-identical to before."""
    B, C, bs, nb = PREFILL_B, PREFILL_C, KERNEL_BS, PREFILL_NB
    rng = np.random.default_rng(4)
    q_len = rng.integers(0, C + 1, size=B)
    q_len[:4] = (0, 1, C, C)
    q_start = rng.integers(0, nb * bs - C + 1, size=B)
    # 0 (fed nothing), 0, a block edge, a chunk across three blocks
    q_start[:4] = (5, 0, bs, 3 * bs - 7)
    for arch, (KV, G, D) in {**ARCH_HEADS, **SMALL_HEADS}.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = dtype_name(dtype)
            args = prefill_inputs(torch, B, C, KV, G, D, bs, nb, dtype,
                                  q_start.tolist(), q_len.tolist(), seed=5)
            out, kp, vp = run_prefill(torch, kernel.flash_prefill_paged,
                                      args)
            want, kp_ref, vp_ref = run_prefill(
                torch, ref.flash_prefill_paged_ref, args)
            valid = (torch.arange(C, device="cuda")[None, :]
                     < args[7][:, None])
            err = (out.float() - want.float())[valid].abs().max().item()
            tol = TOLERANCE[name]
            ok_rows = torch.allclose(out.float()[valid],
                                     want.float()[valid], atol=tol, rtol=tol)
            ok_zeros = not out[~valid].any().item()
            bt = args[5].long()
            ok_pools = (torch.equal(kp[bt], kp_ref[bt])
                        and torch.equal(vp[bt], vp_ref[bt]))
            unnamed = torch.ones(kp.shape[0], dtype=torch.bool,
                                 device="cuda")
            unnamed[bt.reshape(-1)] = False
            ok_foreign = (torch.equal(kp[unnamed], args[3][unnamed])
                          and torch.equal(vp[unnamed], args[4][unnamed]))
            emit({"phase": "kernel", "kernel": "flash_prefill_paged",
                  "arch_heads": arch, "dtype": name, "B": B, "C": C,
                  "KV": KV, "G": G, "D": D, "bs": bs, "nb": nb,
                  "q_start": q_start.tolist(), "q_len": q_len.tolist(),
                  "max_abs_err": err, "tol": tol, "rows_ok": bool(ok_rows),
                  "zeros_past_q_len": ok_zeros, "pools_equal": ok_pools,
                  "unnamed_blocks_untouched": ok_foreign})
            require(ok_rows and ok_zeros and ok_pools and ok_foreign,
                    f"prefill kernel != plain for {arch} {name}: rows "
                    f"{ok_rows} (max abs err {err}, tolerance {tol}), zeros "
                    f"{ok_zeros}, pools {ok_pools}, unnamed {ok_foreign}")


def prefill_timing(torch, np, kernel, ref, arch="qwen3-1.7b", C=PREFILL_C,
                   nb=PREFILL_NB, q_hi=448, shapes="chunked"):
    """Kernel pair, plain version and a library yardstick at the chunked
    serve phases' shapes: 8 slots, chunks of ``C`` (64) rows, the arch's
    heads, ``nb`` (64) blocks of 16, bf16, q_start drawn over 0..``q_hi``
    (448); speculative decoding's steps run it at C 1 (a draft round) and
    ``SPEC_K + 1`` (a verification) over 16 blocks.  The yardstick is one
    ``index_put_`` commit per pool and one SDPA call with a causal mask
    over K/V gathered beforehand."""
    import torch.nn.functional as F

    B, bs = PREFILL_B, KERNEL_BS
    KV, G, D = ARCH_HEADS[arch]
    q_start = np.random.default_rng(6).integers(0, q_hi + 1, size=B)
    q_len = np.full(B, C)
    args = prefill_inputs(torch, B, C, KV, G, D, bs, nb, torch.bfloat16,
                          q_start.tolist(), q_len.tolist(), seed=7)
    q, k_new, v_new, k_pool, v_pool, bt, qs, ql = args
    out = kernel.flash_prefill_paged(*args)   # commits into the pools
    want = ref.flash_prefill_paged_ref(*args)
    err = (out.float() - want.float()).abs().max().item()
    tol = TOLERANCE["bfloat16"]
    require(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol),
            f"prefill kernel != plain at serve shapes: max abs err {err}")

    S = nb * bs
    pos = qs.long()[:, None] + torch.arange(C, device="cuda")
    flat = (bt.long().gather(1, pos // bs) * bs + pos % bs).reshape(-1)
    k_flat = k_pool.view(-1, KV, D)
    v_flat = v_pool.view(-1, KV, D)
    k_rows = k_new.reshape(-1, KV, D)
    v_rows = v_new.reshape(-1, KV, D)
    k = k_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    v = v_pool[bt.long()].reshape(B, S, KV, D).transpose(1, 2)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qh = q.reshape(B, C, KV * G, D).transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= pos[:, :, None])[:, None]

    def library():
        k_flat.index_put_((flat,), k_rows)
        v_flat.index_put_((flat,), v_rows)
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib = library().transpose(1, 2).reshape(out.shape)
    lib_err = (lib.float() - want.float()).abs().max().item()
    require(lib_err <= 2 * tol, f"SDPA yardstick disagrees: {lib_err}")
    bound_ms, bound_by = bound(
        ref.prefill_work_terms(q, k_pool, bt, q_start, q_len), "bfloat16")

    # the commit rows are selected before the timed calls: selecting them
    # waits for the device, which would put the host's time in the events
    rows = ref.commit_rows(bt, qs, ql, C, bs)
    timed = {"ms": lambda: kernel.flash_prefill_paged(*args),
             "plain_ms": lambda: ref.flash_prefill_paged_ref(*args,
                                                             rows=rows),
             "library_ms": library}
    waits = {key: host_waits(torch, fn) for key, fn in timed.items()}
    require(not any(waits["plain_ms"]),
            f"the timed plain version waits for the device: {waits}")
    row = {"max_abs_err": err,
           **{key: device_ms(torch, fn) for key, fn in timed.items()},
           "bound_ms": bound_ms, "bound_by": bound_by,
           "host_us": host_us(torch, timed["ms"])}
    emit({"phase": "kernel", "kernel": "flash_prefill_paged",
          "shapes": f"serve {arch} {shapes}", "B": B, "C": C, "KV": KV,
          "G": G, "D": D, "bs": bs, "nb": nb, "dtype": "bfloat16",
          "plan": kernel.prefill_plan(C, G, D, bs, nb, torch.bfloat16,
                                      torch.bfloat16)._asdict(),
          "q_start": q_start.tolist(), "host_waits": waits, **row})
    return row


# -- quantized paging: int8 and bf16-under-f32 pools --------------------------

def as_pools(torch, ref, k_pool, v_pool, pool_dtype):
    """(k_pool, v_pool, k_scale, v_scale) in ``pool_dtype`` from pools of
    another dtype: int8 by the plain quantizer, with its scales, or a
    cast with no scales."""
    if pool_dtype == torch.int8:
        (kq, ks), (vq, vs) = (ref.quantize_rows(k_pool),
                              ref.quantize_rows(v_pool))
        return kq, vq, ks, vs
    return k_pool.to(pool_dtype), v_pool.to(pool_dtype), None, None


def poison_rows(torch, pools, bt, first, bs):
    """Copies of ``pools`` (k, v, k_scale, v_scale; None kept) with every
    row of each slot's table at or past position ``first[b]`` poisoned:
    int8 codes +127 / -127, scales 1e4 / NaN, float rows 1e4 / NaN."""
    nb = bt.shape[1]
    pos = torch.arange(nb * bs, device=bt.device)
    mask = pos[None, :] >= first.long()[:, None]
    blk = bt.long()[:, pos // bs][mask]
    row = (pos % bs)[None, :].expand_as(mask)[mask]
    out = [None if t is None else t.clone() for t in pools]
    for t, value in zip(out, (1e4, float("nan"), 1e4, float("nan"))):
        if t is not None:
            t[blk, row] = (127 if value == 1e4 else -127) \
                if t.dtype == torch.int8 else value
    return out


def mixed_pairs(kernel) -> list:
    """The kernels' (q dtype, pool dtype) pairs whose pools are not in q's
    dtype, as dtype names."""
    return [(dtype_name(q), dtype_name(p)) for q, p in kernel.POOL_PAIRS
            if q != p]


def check_quantized_decode(torch, np, kernel, ref):
    """Kernel #1 on int8 pools (per-row scales) and bf16 pools under an f32
    q against its plain version at every head shape, shuffled tables and
    ragged lengths; then the rows and scales past each slot's length
    poisoned, which must leave the kernel's output bit-identical."""
    B, bs, nb = KERNEL_B, KERNEL_BS, KERNEL_NB
    rng = np.random.default_rng(0)
    valid = rng.integers(1, nb * bs + 1, size=B)
    valid[:4] = (1, bs, bs + 1, nb * bs)
    for arch, (KV, G, D) in {**ARCH_HEADS, **SMALL_HEADS}.items():
        for q_name, pool_name in mixed_pairs(kernel):
            q, kp, vp, bt, vl = paged_inputs(torch, B, KV, G, D, bs, nb,
                                             torch.float32, valid.tolist(),
                                             seed=1)
            q = q.to(getattr(torch, q_name))
            pools = as_pools(torch, ref, kp, vp, getattr(torch, pool_name))
            out = kernel.flash_decode_paged(q, pools[0], pools[1], bt, vl,
                                            *pools[2:])
            torch.cuda.synchronize()
            want = ref.flash_decode_paged_ref(q, pools[0], pools[1], bt, vl,
                                              *pools[2:])
            err, ok = decode_close(torch, out, want)
            rms = want.float().square().mean().sqrt().item()
            bad = poison_rows(torch, pools, bt, vl, bs)
            out2 = kernel.flash_decode_paged(q, bad[0], bad[1], bt, vl,
                                             *bad[2:])
            inert = torch.equal(out, out2)
            emit({"phase": "kernel", "kernel": "flash_decode_paged",
                  "arch_heads": arch, "dtype": q_name, "pool": pool_name,
                  "B": B, "KV": KV, "G": G, "D": D, "bs": bs, "nb": nb,
                  "max_abs_err": err, "err_over_rms": err / rms,
                  "tol": CLOSE_TOL, "ok": ok,
                  "poisoned_past_valid_len_inert": inert})
            require(ok and inert,
                    f"decode kernel != plain for {arch} {q_name} q, "
                    f"{pool_name} pools: max abs err {err} (tolerance "
                    f"{CLOSE_TOL}), poisoned rows inert {inert}")


def check_quantized_prefill(torch, np, kernel, ref):
    """Kernel #2 on int8 pools and bf16 pools under an f32 q against its
    plain version: rows below q_len within tolerance and zeros past it,
    committed codes, rows and scales bit-equal through the tables, blocks
    and scales no table names untouched; then the rows and scales past
    each slot's chunk frontier poisoned, which must leave the output
    bit-identical."""
    B, C, bs, nb = PREFILL_B, PREFILL_C, KERNEL_BS, PREFILL_NB
    rng = np.random.default_rng(4)
    q_len = rng.integers(0, C + 1, size=B)
    q_len[:4] = (0, 1, C, C)
    q_start = rng.integers(0, nb * bs - C + 1, size=B)
    q_start[:4] = (5, 0, bs, 3 * bs - 7)
    for arch, (KV, G, D) in {**ARCH_HEADS, **SMALL_HEADS}.items():
        for q_name, pool_name in mixed_pairs(kernel):
            args = prefill_inputs(torch, B, C, KV, G, D, bs, nb,
                                  torch.float32, q_start.tolist(),
                                  q_len.tolist(), seed=5)
            dt = getattr(torch, q_name)
            q, k_new, v_new = (t.to(dt) for t in args[:3])
            pools = as_pools(torch, ref, args[3], args[4],
                             getattr(torch, pool_name))
            bt, qs, ql = args[5:]

            def run(fn, pools):
                mine = [None if t is None else t.clone() for t in pools]
                out = fn(q, k_new, v_new, mine[0], mine[1], bt, qs, ql,
                         *mine[2:])
                torch.cuda.synchronize()
                return out, mine

            out, got = run(kernel.flash_prefill_paged, pools)
            want, exp = run(ref.flash_prefill_paged_ref, pools)
            valid = (torch.arange(C, device="cuda")[None, :]
                     < ql[:, None])
            err, ok_rows = decode_close(torch, out[valid], want[valid])
            rms = want[valid].float().square().mean().sqrt().item()
            ok_zeros = not out[~valid].any().item()
            named = bt.long()
            unnamed = torch.ones(pools[0].shape[0], dtype=torch.bool,
                                 device="cuda")
            unnamed[named.reshape(-1)] = False
            ok_pools = ok_foreign = True
            for g, e, before in zip(got, exp, pools):
                if g is None:
                    continue
                ok_pools &= torch.equal(g[named], e[named])
                ok_foreign &= torch.equal(g[unnamed], before[unnamed])
            bad = poison_rows(torch, got, bt, qs + ql, bs)
            out2, _ = run(kernel.flash_prefill_paged, bad)
            inert = torch.equal(out, out2)
            emit({"phase": "kernel", "kernel": "flash_prefill_paged",
                  "arch_heads": arch, "dtype": q_name, "pool": pool_name,
                  "B": B, "C": C, "KV": KV, "G": G, "D": D, "bs": bs,
                  "nb": nb, "max_abs_err": err, "err_over_rms": err / rms,
                  "tol": CLOSE_TOL, "rows_ok": ok_rows,
                  "zeros_past_q_len": ok_zeros,
                  "codes_scales_equal": bool(ok_pools),
                  "unnamed_blocks_untouched": bool(ok_foreign),
                  "poisoned_past_frontier_inert": inert})
            require(ok_rows and ok_zeros and ok_pools and ok_foreign
                    and inert,
                    f"prefill kernel != plain for {arch} {q_name} q, "
                    f"{pool_name} pools: rows {ok_rows} (max abs err {err}, "
                    f"tolerance {CLOSE_TOL}), zeros {ok_zeros}, pools "
                    f"{ok_pools}, "
                    f"unnamed {ok_foreign}, poisoned inert {inert}")


def quantized_decode_timing(torch, np, kernel, ref):
    """Kernel #1 on int8 pools at the qwen3-1.7b serve shapes of row 1 (8
    slots, 64 blocks of 16, bf16 q, lengths over 1..544), beside the same
    call on bf16 pools, its plain version, and a library composite:
    dequantize the gathered, expanded codes to bf16, then one SDPA call."""
    import torch.nn.functional as F

    B, bs, nb = 8, 16, 64
    KV, G, D = ARCH_HEADS["qwen3-1.7b"]
    valid = np.random.default_rng(8).integers(1, 512 + 32 + 1, size=B)
    q, kp, vp, bt, vl = paged_inputs(torch, B, KV, G, D, bs, nb,
                                     torch.float32, valid.tolist(), seed=9)
    q = q.to(torch.bfloat16)
    kq, vq, ks, vs = as_pools(torch, ref, kp, vp, torch.int8)
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    args = (q, kq, vq, bt, vl, ks, vs)
    out = kernel.flash_decode_paged(*args)
    want = ref.flash_decode_paged_ref(*args)
    err, ok = decode_close(torch, out, want)
    rms = want.float().square().mean().sqrt().item()
    require(ok, f"int8 decode kernel != plain at serve shapes: max abs err "
                f"{err} (tolerance {CLOSE_TOL})")
    tol = TOLERANCE["bfloat16"]

    S = nb * bs
    idx = bt.long()

    def expand(pool):  # (B, KV*G, S, ...) gathered beforehand
        g = pool[idx].reshape(B, S, KV, *pool.shape[3:]).transpose(1, 2)
        return g.repeat_interleave(G, dim=1).contiguous()

    kc, vc = expand(kq), expand(vq)
    ksc = ks[idx].reshape(B, 1, S, 1).expand(B, KV * G, S, 1).contiguous()
    vsc = vs[idx].reshape(B, 1, S, 1).expand(B, KV * G, S, 1).contiguous()
    qh = q.reshape(B, KV * G, 1, D)
    mask = (torch.arange(S, device="cuda")[None, :] < vl[:, None])
    mask = mask[:, None, None, :]

    def library():
        k = (kc.float() * ksc).to(torch.bfloat16)
        v = (vc.float() * vsc).to(torch.bfloat16)
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (library().reshape(out.shape).float()
               - want.float()).abs().max().item()
    require(lib_err <= 2 * tol, f"dequantize + SDPA disagrees: {lib_err}")
    bound_ms, bound_by = bound(ref.work_terms(q, kq, bt, valid, True),
                               "bfloat16")
    row = {
        "max_abs_err": err, "err_over_rms": err / rms,
        "ms": device_ms(torch, lambda: kernel.flash_decode_paged(*args)),
        "bf16_pools_ms": device_ms(torch, lambda: kernel.flash_decode_paged(
            q, kb, vb, bt, vl)),
        "plain_ms": device_ms(torch,
                              lambda: ref.flash_decode_paged_ref(*args)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bf16_pools_bound_ms": bound(ref.work_terms(q, kb, bt, valid),
                                     "bfloat16")[0],
        "library_ms": device_ms(torch, library),
    }
    emit({"phase": "kernel", "kernel": "flash_decode_paged",
          "shapes": "serve qwen3-1.7b", "B": B, "KV": KV, "G": G, "D": D,
          "bs": bs, "nb": nb, "dtype": "bfloat16", "pool": "int8",
          "valid_len": valid.tolist(), **row})
    return row


def quantized_prefill_timing(torch, np, kernel, ref):
    """Kernel #2 with the quantizing commit and the dequantizing attend at
    row 2's shapes (8 slots, chunks of 64, qwen3-1.7b heads, 64 blocks of
    16, bf16 q, int8 pools), beside the same call on bf16 pools, its plain
    version, and a library composite: quantize the rows, ``index_put_``
    codes and scales, dequantize the gathered codes to bf16, one causal
    SDPA call."""
    import torch.nn.functional as F

    B, C, bs, nb = PREFILL_B, PREFILL_C, KERNEL_BS, PREFILL_NB
    KV, G, D = ARCH_HEADS["qwen3-1.7b"]
    q_start = np.random.default_rng(6).integers(0, 449, size=B)
    q_len = np.full(B, C)
    args = prefill_inputs(torch, B, C, KV, G, D, bs, nb, torch.bfloat16,
                          q_start.tolist(), q_len.tolist(), seed=7)
    q, k_new, v_new, kb, vb, bt, qs, ql = args
    kq, vq, ks, vs = as_pools(torch, ref, kb.float(), vb.float(), torch.int8)
    qargs = (q, k_new, v_new, kq, vq, bt, qs, ql, ks, vs)
    out = kernel.flash_prefill_paged(*qargs)   # commits into the pools
    want = ref.flash_prefill_paged_ref(*qargs)
    err, ok = decode_close(torch, out, want)
    rms = want.float().square().mean().sqrt().item()
    require(ok, f"int8 prefill kernel != plain at serve shapes: max abs err "
                f"{err} (tolerance {CLOSE_TOL})")
    tol = TOLERANCE["bfloat16"]

    S = nb * bs
    pos = qs.long()[:, None] + torch.arange(C, device="cuda")
    flat = (bt.long().gather(1, pos // bs) * bs + pos % bs).reshape(-1)
    k_rows = k_new.reshape(-1, KV, D)
    v_rows = v_new.reshape(-1, KV, D)
    idx = bt.long()

    def expand(pool):
        g = pool[idx].reshape(B, S, KV, *pool.shape[3:]).transpose(1, 2)
        return g.repeat_interleave(G, dim=1).contiguous()

    kc, vc = expand(kq), expand(vq)
    ksc = ks[idx].reshape(B, 1, S, 1).expand(B, KV * G, S, 1).contiguous()
    vsc = vs[idx].reshape(B, 1, S, 1).expand(B, KV * G, S, 1).contiguous()
    qh = q.reshape(B, C, KV * G, D).transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= pos[:, :, None])[:, None]

    def library():
        for rows, pool, scale in ((k_rows, kq, ks), (v_rows, vq, vs)):
            codes, s = ref.quantize_rows(rows)
            pool.view(-1, KV, D).index_put_((flat,), codes)
            scale.view(-1).index_put_((flat,), s)
        k = (kc.float() * ksc).to(torch.bfloat16)
        v = (vc.float() * vsc).to(torch.bfloat16)
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib = library().transpose(1, 2).reshape(out.shape)
    lib_err = (lib.float() - want.float()).abs().max().item()
    require(lib_err <= 2 * tol, f"library composite disagrees: {lib_err}")
    bound_ms, bound_by = bound(ref.prefill_work_terms(
        q, kq, bt, q_start, q_len, True), "bfloat16")
    rows = ref.commit_rows(bt, qs, ql, C, bs)
    timed = {"ms": lambda: kernel.flash_prefill_paged(*qargs),
             "bf16_pools_ms": lambda: kernel.flash_prefill_paged(*args),
             "plain_ms": lambda: ref.flash_prefill_paged_ref(*qargs,
                                                             rows=rows),
             "library_ms": library}
    waits = {key: host_waits(torch, fn) for key, fn in timed.items()}
    require(not any(waits["plain_ms"]),
            f"the timed plain version waits for the device: {waits}")
    row = {"max_abs_err": err, "err_over_rms": err / rms,
           **{key: device_ms(torch, fn) for key, fn in timed.items()},
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel", "kernel": "flash_prefill_paged",
          "shapes": "serve qwen3-1.7b chunked", "B": B, "C": C, "KV": KV,
          "G": G, "D": D, "bs": bs, "nb": nb, "dtype": "bfloat16",
          "pool": "int8", "plan": kernel.prefill_plan(
              C, G, D, bs, nb, torch.bfloat16, torch.int8)._asdict(),
          "q_start": q_start.tolist(), "host_waits": waits, **row})
    return row


def commit_timing(torch, np, kernel, ref, pool_dtype):
    """The commit kernel alone, as a decode step of the serve phases runs
    it: one row for each of 8 slots, qwen3-1.7b heads, bf16 rows into
    pools of 64 blocks of 16 in ``pool_dtype`` (bf16 or int8); checked
    bit-equal to its plain version (codes and scales for int8), and timed
    beside it.  With bf16 pools the library yardstick is the two
    ``index_put_`` calls that write the same rows; no one library call
    quantizes rows.  The host's time a call is measured too, for the
    commit as a decode layer calls it (with its ``q_len`` of ones made
    there) and for the two ``index_put_`` calls: the serve steps are
    host-bound."""
    B, bs, nb = 8, 16, 64
    KV, G, D = ARCH_HEADS["qwen3-1.7b"]
    q_start = np.random.default_rng(10).integers(0, nb * bs, size=B)
    args = prefill_inputs(torch, B, 1, KV, G, D, bs, nb, torch.bfloat16,
                          q_start.tolist(), [1] * B, seed=11)
    _, k_new, v_new, kb, vb, bt, qs, ql = args
    pools = as_pools(torch, ref, kb.float(), vb.float(), pool_dtype)
    quantized = pool_dtype == torch.int8
    got = [None if t is None else t.clone() for t in pools]
    exp = [None if t is None else t.clone() for t in pools]
    kernel.commit_paged(k_new, v_new, got[0], got[1], bt, qs, ql, *got[2:])
    ref.commit_paged_ref(k_new, v_new, exp[0], exp[1], bt, qs, ql, *exp[2:])
    torch.cuda.synchronize()
    pairs = [(g, e) for g, e in zip(got, exp) if g is not None]
    err = max((g.float() - e.float()).abs().max().item() for g, e in pairs)
    require(all(torch.equal(g, e) for g, e in pairs),
            f"commit kernel != plain into {dtype_name(pool_dtype)} pools: "
            f"pools or scales differ by up to {err}")
    src, dst = ref.commit_rows(bt, qs, ql, 1, bs)
    k_rows = k_new.reshape(-1, KV, D)[src]
    v_rows = v_new.reshape(-1, KV, D)[src]

    def library():
        got[0].view(-1, KV, D).index_put_((dst,), k_rows)
        got[1].view(-1, KV, D).index_put_((dst,), v_rows)

    bound_ms, bound_by = bound(ref.commit_work_terms(k_new, got[0], [1] * B,
                                                     quantized), "bfloat16")
    def layer_commit():
        kernel.commit_paged(k_new, v_new, got[0], got[1], bt, qs,
                            torch.ones_like(qs), *got[2:])

    row = {"max_abs_err": err,
           "ms": device_ms(torch, lambda: kernel.commit_paged(
               k_new, v_new, got[0], got[1], bt, qs, ql, *got[2:])),
           "plain_ms": device_ms(torch, lambda: ref.commit_paged_ref(
               k_new, v_new, exp[0], exp[1], bt, qs, ql, *exp[2:],
               rows=(src, dst))),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None if quantized else device_ms(torch, library)}
    host = {"commit_paged": host_us(torch, layer_commit)}
    if not quantized:
        host["index_put_x2"] = host_us(torch, library)
    emit({"phase": "kernel", "kernel": "commit_paged", "host_us": host,
          "shapes": "serve qwen3-1.7b decode step", "B": B, "C": 1,
          "KV": KV, "D": D, "bs": bs, "nb": nb, "dtype": "bfloat16",
          "pool": dtype_name(pool_dtype), **row})
    return row


# -- the decode launch that commits its rows ----------------------------------


def new_rows(torch, B, KV, D, dtype, seed):
    """Each slot's new K and V row (B, KV, D), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, KV, D), device="cuda", generator=gen).to(dtype)
            for _ in range(2)]


def _clones(pools):
    return [None if t is None else t.clone() for t in pools]


def _pools_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


def fused_pair(torch, kernel, q, pools, bt, vl, k_new, v_new):
    """The parent's two launches a decode layer: the commit kernel with
    ``q_start = valid_len - 1`` and ``q_len`` of ones, then the decode."""
    kernel.commit_paged(k_new[:, None], v_new[:, None], pools[0], pools[1],
                        bt, vl - 1, torch.ones_like(vl), *pools[2:])
    return kernel.flash_decode_paged(q, pools[0], pools[1], bt, vl,
                                     *pools[2:])


def check_fused_commit(torch, np, kernel, ref):
    """The decode launch given each slot's new row (``k_new``/``v_new``)
    against the commit kernel then the decode, bit for bit (output, pools
    and scales): every (q, pool) pair at every head shape (D 16 to 128,
    4 blocks a slot) and at the serve shapes (16 and 64 blocks), lengths
    of one row, at block and split edges and of the whole table; then the
    head slices (i, n), n in 2 and 4, each given its heads of the rows
    (and for int8 each row's amax over all heads), concatenated, against
    the same pair.  Returns the cases checked."""
    B, bs = 8, 16
    split = kernel.decode_split_rows(bs)
    shapes = {**{name: (h, 4) for name, h in
                 {**ARCH_HEADS, **SMALL_HEADS}.items()},
              "gpt2-124m serve": (ARCH_HEADS["gpt2-124m"], 16),
              "qwen3-1.7b serve": (ARCH_HEADS["qwen3-1.7b"], 64),
              "jamba-1.5-large-398b serve":
                  (ARCH_HEADS["jamba-1.5-large-398b"], 64)}
    rng = np.random.default_rng(31)
    cases = slices = 0
    for name, ((KV, G, D), nb) in shapes.items():
        rows = nb * bs
        valid = rng.integers(1, rows + 1, size=B)
        edges = sorted({min(e, rows) for e in (1, bs, bs + 1, split,
                                                split + 1, rows)})
        valid[:len(edges)] = edges
        for q_dtype, pool_dtype in kernel.POOL_PAIRS:
            (q, kp, vp, bt, vl), scales = _sharded_inputs(
                torch, ref, B, KV, G, D, bs, nb, q_dtype, pool_dtype,
                valid.tolist(), seed=100 + cases)
            k_new, v_new = new_rows(torch, B, KV, D, q_dtype, seed=cases)
            pools = [kp, vp, *scales]
            pair, fused = _clones(pools), _clones(pools)
            want = fused_pair(torch, kernel, q, pair, bt, vl, k_new, v_new)
            got = kernel.flash_decode_paged(q, fused[0], fused[1], bt, vl,
                                            *fused[2:], k_new=k_new,
                                            v_new=v_new)
            torch.cuda.synchronize()
            what = (f"{name} {dtype_name(q_dtype)}/"
                    f"{dtype_name(pool_dtype)}")
            require(torch.equal(got, want) and _pools_equal(torch, fused,
                                                            pair),
                    f"fused commit != commit then decode at {what}")
            amax = {}
            if pool_dtype == torch.int8:
                amax = dict(k_amax=ref.row_amax(k_new),
                            v_amax=ref.row_amax(v_new))
            for n in (2, 4):
                if KV % n:
                    continue
                part_pools = _clones(pools)
                parts = []
                for i in range(n):
                    h = ref.head_slice((i, n), KV)
                    parts.append(kernel.flash_decode_paged(
                        q, part_pools[0], part_pools[1], bt, vl,
                        *part_pools[2:], head_shard=(i, n),
                        k_new=k_new[:, h].contiguous(),
                        v_new=v_new[:, h].contiguous(), **amax))
                torch.cuda.synchronize()
                require(torch.equal(torch.cat(parts, dim=1), want)
                        and _pools_equal(torch, part_pools, pair),
                        f"fused commit slices (i, {n}) != commit then "
                        f"decode at {what}")
                slices += n
            cases += 1
    emit({"phase": "kernel", "kernel": "flash_decode_paged_commit",
          "shapes": {name: [*h, nb] for name, (h, nb) in shapes.items()},
          "pairs": [f"{dtype_name(a)}/{dtype_name(b)}"
                    for a, b in kernel.POOL_PAIRS],
          "bit_equal_cases": cases, "bit_equal_slices": slices})
    return cases


def fused_commit_timing(torch, np, kernel, ref, arch, nb, max_valid, seed,
                        pool_dtype):
    """The decode launch that commits its rows at a serve phase's shapes
    (8 slots, ``nb`` blocks of 16, the arch's heads, bf16 q over
    ``pool_dtype`` pools, lengths as ``decode_timing`` draws them), held
    bit-equal to the commit kernel then the decode and within
    ``decode_close`` of the plain versions; then timed beside: its bound
    (the decode's bytes plus the commit's), the plain commit then the
    plain decode, the two-launch pair, and for bf16 pools a library
    composite (two ``index_put_`` of the rows, then SDPA over K/V gathered
    beforehand).  The host's time is taken for the fused call and for the
    pair as a decode layer made it (with the commit's ``q_len`` of ones
    made there)."""
    import torch.nn.functional as F

    B, bs = 8, 16
    KV, G, D = ARCH_HEADS[arch]
    valid = np.random.default_rng(seed).integers(1, max_valid + 1, size=B)
    q, kp, vp, bt, vl = paged_inputs(torch, B, KV, G, D, bs, nb,
                                     torch.float32, valid.tolist(),
                                     seed=seed + 1)
    q = q.to(torch.bfloat16)
    pools = list(as_pools(torch, ref, kp, vp, pool_dtype))
    k_new, v_new = new_rows(torch, B, KV, D, torch.bfloat16, seed)
    kn, vn = k_new[:, None], v_new[:, None]
    quantized = pool_dtype == torch.int8
    pair, fused, plain = _clones(pools), _clones(pools), _clones(pools)
    want = fused_pair(torch, kernel, q, pair, bt, vl, k_new, v_new)
    got = kernel.flash_decode_paged(q, fused[0], fused[1], bt, vl,
                                    *fused[2:], k_new=k_new, v_new=v_new)
    pos, ones = vl - 1, torch.ones_like(vl)
    rows = ref.commit_rows(bt, pos, ones, 1, bs)

    def plain_call():
        ref.commit_paged_ref(kn, vn, plain[0], plain[1], bt, pos, ones,
                             *plain[2:], rows=rows)
        return ref.flash_decode_paged_ref(q, plain[0], plain[1], bt, vl,
                                          *plain[2:])

    expect = plain_call()
    torch.cuda.synchronize()
    require(torch.equal(got, want) and _pools_equal(torch, fused, pair),
            f"fused commit != commit then decode at {arch} serve shapes, "
            f"{dtype_name(pool_dtype)} pools")
    err, ok = decode_close(torch, got, expect)
    require(ok, f"fused commit != plain at {arch} serve shapes: {err}")

    def fused_call():
        return kernel.flash_decode_paged(q, fused[0], fused[1], bt, vl,
                                         *fused[2:], k_new=k_new,
                                         v_new=v_new)

    def layer_pair():  # as the parent's decode layer called them
        kernel.commit_paged(kn, vn, pair[0], pair[1], bt, pos,
                            torch.ones_like(pos), *pair[2:])
        return kernel.flash_decode_paged(q, pair[0], pair[1], bt, vl,
                                         *pair[2:])

    library_ms = None
    if not quantized:
        S = nb * bs
        k = pair[0][bt.long()].reshape(B, S, KV, D).transpose(1, 2)
        v = pair[1][bt.long()].reshape(B, S, KV, D).transpose(1, 2)
        k = k.repeat_interleave(G, dim=1).contiguous()
        v = v.repeat_interleave(G, dim=1).contiguous()
        qh = q.reshape(B, KV * G, 1, D)
        mask = (torch.arange(S, device="cuda")[None, :] < vl[:, None])
        mask = mask[:, None, None, :]
        src, dst = rows
        k_rows, v_rows = k_new[src], v_new[src]

        def library():
            pair[0].view(-1, KV, D).index_put_((dst,), k_rows)
            pair[1].view(-1, KV, D).index_put_((dst,), v_rows)
            return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

        lib_err = (library().reshape(got.shape).float()
                   - expect.float()).abs().max().item()
        require(lib_err <= 2 * TOLERANCE["bfloat16"],
                f"index_put_ + SDPA yardstick disagrees: {lib_err}")
        library_ms = device_ms(torch, library)
    decode = ref.work_terms(q, pools[0], bt, valid, quantized)
    commit = ref.commit_work_terms(kn, pools[0], [1] * B, quantized)
    bound_ms, bound_by = bound({"bytes": decode["bytes"] + commit["bytes"],
                                "flops": decode["flops"]}, "bfloat16")
    row = {"max_abs_err": err,
           "ms": device_ms(torch, fused_call),
           "plain_ms": device_ms(torch, plain_call),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms,
           "host_us": host_us(torch, fused_call),
           "pair_ms": device_ms(torch, lambda: fused_pair(
               torch, kernel, q, pair, bt, vl, k_new, v_new)),
           "pair_host_us": host_us(torch, layer_pair)}
    emit({"phase": "kernel", "kernel": "flash_decode_paged_commit",
          "shapes": f"serve {arch}", "B": B, "KV": KV, "G": G, "D": D,
          "bs": bs, "nb": nb, "dtype": "bfloat16",
          "pool": dtype_name(pool_dtype), "valid_len": valid.tolist(),
          **row})
    return row


# -- HPC kernels: the analysis suite --------------------------------------------

#: full sizes: every array well past the 50 MB L2 (SpMV's x excepted)
STREAM_SHAPE = (1 << 21, 128)  # 2^28 fp32 a array, 1 GiB
STREAM_Q = 3.0
GEMM_N = 8192
JACOBI_N = 16384
SPMV_ROWS, SPMV_MAX_NNZ, SPMV_WIDTH = 1 << 20, 64, 128
HPC_SOURCES = "src/repro_torch/kernels/"
TPU_HPC = "src/repro/kernels/"
STREAM_OPS = ("copy", "scale", "add", "triad")


#: GEMM cases of the kernel-hpc phase: (dtype, offset of A in elements,
#: (M, N, K) shapes).  bf16 at offset 0 with K and N multiples of 8 takes
#: the wgmma route, at its edges (M and N past whole tiles, K = 8, K % 64
#: != 0, a shape inside one tile, one exact tile); everything else the
#: simt route: fp32, bf16 with K or N not a multiple of 8, and a misaligned
#: A (offset 1).
GEMM_CASES = (
    ("float32", 0, ((1, 1, 1), (100, 130, 70), (257, 129, 33),
                    (128, 128, 256), (256, 256, 512), (300, 260, 100))),
    ("float32", 1, ((129, 132, 64),)),
    ("bfloat16", 0, ((1, 1, 1), (100, 130, 70), (257, 129, 33),
                     (128, 128, 256), (256, 256, 512), (1, 8, 8),
                     (100, 136, 8), (130, 264, 200), (128, 256, 64),
                     (300, 520, 1000), (1024, 1024, 4096))),
    ("bfloat16", 1, ((129, 264, 72),)),
)


def gemm_route(gemm, before) -> str:
    """The one route whose count rose since ``before``, or "none"."""
    rose = [r for r, n in gemm.gemm.route_launches.items() if n != before[r]]
    return rose[0] if len(rose) == 1 else "none"


def gemm_expected_route(dtype: str, N, K, offset) -> str:
    """The route the rule names (written out here, not read from the
    plan): wgmma for bf16 that TMA can address, simt otherwise."""
    tma = K % 8 == 0 and N % 8 == 0 and offset == 0
    return "wgmma" if dtype == "bfloat16" and tma else "simt"


def hpc_modules():
    from repro_torch.kernels.gemm import kernel as gemm
    from repro_torch.kernels.jacobi2d import kernel as jacobi
    from repro_torch.kernels.spmv import kernel as spmv
    from repro_torch.kernels.stream import kernel as stream

    return gemm, jacobi, spmv, stream


def hpc_entries():
    """{counter name: wrapper} of every HPC kernel entry point."""
    gemm, jacobi, spmv, stream = hpc_modules()
    entries = {f"stream_{op}": getattr(stream, f"stream_{op}")
               for op in STREAM_OPS}
    entries.update(gemm=gemm.gemm, jacobi_step=jacobi.jacobi_step,
                   spmv_blockell=spmv.spmv_blockell,
                   spmv_fixed_width=spmv.spmv_fixed_width)
    return entries


def ulp(torch, x, dtype):
    """Spacing of ``dtype`` numbers at |x| (normal range), as fp32."""
    mantissa = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
    e = torch.floor(torch.log2(x.abs().float().clamp_min(1e-30)))
    return torch.exp2(e - mantissa[dtype])


def exact_close(torch, got, want):
    """STREAM and Jacobi2D: the kernel and its plain version round the same
    fp32 values, so fp32 must be bit-equal and 16-bit within one ulp.
    Returns (max abs err, ok, bit-equal)."""
    err = (got.float() - want.float()).abs()
    tol = 0.0 if got.dtype == torch.float32 else ulp(torch, want, got.dtype)
    return (err.max().item(), bool((err <= tol).all()),
            bool(torch.equal(got, want)))


def gemm_close(torch, got, want):
    """fp32 sums along K in another order: 1e-5 * max|want|, plus one ulp
    of the result in bf16 (one rounding at the flush)."""
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * want.float().abs().max()
    if got.dtype == torch.bfloat16:
        tol = tol + ulp(torch, want, got.dtype)
    return err.max().item(), bool((err <= tol).all())


def spmv_close(torch, got, want, scale):
    """Row sums in another order: 1e-6 of the row's sum of |terms|
    (``scale``; an fp32 sum of 128 lanes reordered as a tree is off by at
    most about log2(128) + 1 roundings of it), plus rtol 1e-5 in fp32 or
    one ulp of the result in bf16."""
    err = (got.float() - want.float()).abs()
    tol = 1e-6 * scale.float()
    tol = tol + (1e-5 * want.float().abs() if got.dtype == torch.float32
                 else ulp(torch, want, got.dtype))
    return err.max().item(), bool((err <= tol).all())


def spmv_scale(ref, values, cols, nnz, x, **kw):
    """Each row's sum of |terms|, by the plain version."""
    return ref.spmv_plain(values.abs(), cols, nnz, x.abs(), **kw)


def report_cases(phase, kernel, cases):
    """One line for a kernel's checks against its plain version; fails the
    run if any case failed."""
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": phase, "kernel": kernel, "cases": len(cases),
          "max_abs_err": max(c["max_abs_err"] for c in cases),
          "bit_equal": all(c.get("bit_equal", False) for c in cases),
          "failed": bad})
    require(not bad, f"{kernel} kernel != plain: {bad}")


def check_hpc(torch, np):
    """Each HPC kernel against its plain version on the card: STREAM in
    fp32/bf16/fp16 on aligned, odd and misaligned arrays (the 16-byte and
    the one-element paths); Jacobi2D in fp32/bf16 on odd sizes and grids
    with H or W below 3; GEMM in fp32/bf16 on sizes no tile divides; SpMV
    in fp32/bf16, predicated (repeat 1, 4, 20) and fixed width, with rows
    of 0, 1 and 128 nonzeros, and predicated lanes poisoned with NaN, then
    at the plan's edge widths and on misaligned inputs
    (:func:`spmv_edge_cases`)."""
    from repro_torch.kernels.spmv import ref as spmv_ref

    gemm, jacobi, spmv, stream = hpc_modules()
    gen = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16

    def randn(shape, dtype):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    cases = []
    for dtype in (f32, bf16, f16):
        for rows, width, offset in ((64, 128, 0), (37, 100, 0), (37, 100, 1)):
            n = rows * width
            a, b = (randn((n + offset,), dtype)[offset:].view(rows, width)
                    for _ in range(2))
            for op in STREAM_OPS:
                args = {"copy": (a,), "scale": (a, 0.3), "add": (a, b),
                        "triad": (a, b, 0.3)}[op]
                got = getattr(stream, f"stream_{op}")(*args, block_rows=rows)
                want = getattr(stream, f"stream_{op}_plain")(
                    *args, block_rows=rows)
                torch.cuda.synchronize()
                err, ok, bit = exact_close(torch, got, want)
                cases.append({"op": op, "dtype": dtype_name(dtype),
                              "shape": [rows, width], "offset": offset,
                              "max_abs_err": err, "ok": ok, "bit_equal": bit})
    report_cases("kernel-hpc", "stream", cases)

    cases = []
    for dtype in (f32, bf16):
        for H, W in ((1, 5), (2, 7), (7, 2), (3, 3), (67, 1001), (300, 129)):
            u = randn((H, W), dtype)
            got = jacobi.jacobi_step(u, block_rows=H)
            want = jacobi.jacobi_step_plain(u, block_rows=H)
            torch.cuda.synchronize()
            err, ok, bit = exact_close(torch, got, want)
            ring = bool(torch.equal(got[[0, -1]], u[[0, -1]])
                        and torch.equal(got[:, [0, -1]], u[:, [0, -1]]))
            cases.append({"dtype": dtype_name(dtype), "shape": [H, W],
                          "max_abs_err": err, "ok": ok and ring,
                          "bit_equal": bit, "ring_passes": ring})
    report_cases("kernel-hpc", "jacobi_step", cases)

    cases = []
    for dtype, offset, shapes in GEMM_CASES:
        for M, N, K in shapes:
            x = randn((M * K + offset,), getattr(torch, dtype))[offset:]
            x, y = x.view(M, K), randn((K, N), getattr(torch, dtype))
            before = dict(gemm.gemm.route_launches)
            got = gemm.gemm(x, y, bm=M, bn=N, bk=K)
            want = gemm.gemm_plain(x, y, bm=M, bn=N, bk=K)
            torch.cuda.synchronize()
            err, ok = gemm_close(torch, got, want)
            route = gemm_route(gemm, before)
            expect = gemm_expected_route(dtype, N, K, offset)
            cases.append({"dtype": dtype, "shape": [M, N, K],
                          "offset": offset, "route": route,
                          "max_abs_err": err, "ok": ok and route == expect})
    report_cases("kernel-hpc", "gemm", cases)

    cases = []
    for dtype in (f32, bf16):
        vals, cols, nnz = spmv_ref.make_problem(
            1000, 3000, row_block=8, max_nnz=64, width_pad=128, dtype=dtype,
            generator=gen, device="cuda")
        nnz[0, :3] = torch.tensor([0, 1, 128], dtype=torch.int32)
        vals[0, 0] = 0
        vals[0, 1, 1:] = 0
        vals[0, 2] = randn((128,), dtype)
        x = randn((3000,), dtype)
        lane = torch.arange(128, device="cuda")
        poisoned = torch.where(lane < nnz[..., None], vals,
                               torch.tensor(float("nan"), dtype=dtype,
                                            device="cuda"))
        for repeat in (1, 4, 20):
            args = (vals, cols, nnz, x)
            got = spmv.spmv_blockell(*args, repeat=repeat)
            want = spmv.spmv_blockell_plain(*args, repeat=repeat)
            inert = spmv.spmv_blockell(poisoned, cols, nnz, x, repeat=repeat)
            torch.cuda.synchronize()
            err, ok = spmv_close(torch, got, want,
                                 spmv_scale(spmv_ref, *args, repeat=repeat))
            cases.append({"variant": "predicated", "repeat": repeat,
                          "dtype": dtype_name(dtype), "max_abs_err": err,
                          "ok": ok and bool(torch.equal(inert, got)),
                          "poisoned_lanes_inert": bool(torch.equal(inert,
                                                                   got)),
                          "row_nnz_0_1_128": got[:3].float().tolist()})
        got = spmv.spmv_fixed_width(vals, cols, nnz, x)
        want = spmv.spmv_fixed_width_plain(vals, cols, nnz, x)
        torch.cuda.synchronize()
        err, ok = spmv_close(torch, got, want,
                             spmv_scale(spmv_ref, vals, cols, nnz, x,
                                        predicated=False))
        cases.append({"variant": "fixed_width", "dtype": dtype_name(dtype),
                      "max_abs_err": err, "ok": ok})
        cases += spmv_edge_cases(torch, spmv, spmv_ref, dtype, gen)
    report_cases("kernel-hpc", "spmv", cases)


#: SpMV edge widths: the scalar route (1, 3, 130; bf16 also 4 and 100),
#: the vector routes at one and several passes, and the fixed-width lanes'
#: steps (8, 16 and 32 lanes)
SPMV_EDGE_WIDTHS = (1, 3, 4, 100, 128, 130, 256)


def spmv_edge_cases(torch, spmv, spmv_ref, dtype, gen):
    """Both SpMV kernels at :data:`SPMV_EDGE_WIDTHS`, with row_nnz of 0,
    1, negative, the width and past it, on aligned inputs and on values
    and col_idx one element off a 16-byte line (the scalar route): within
    ``spmv_close`` of the plain version, on the instantiation
    ``spmv_plan`` names (``last_plan``).  Returns the cases."""
    cases = []
    for width in SPMV_EDGE_WIDTHS:
        for offset in (0, 1):
            nb, rb, n_cols = 13, 8, 777
            n = nb * rb * width
            vals = torch.randn((n + offset,), device="cuda",
                               generator=gen).to(dtype)[offset:]
            cols = torch.randint(0, n_cols, (n + offset,), device="cuda",
                                 generator=gen, dtype=torch.int32)[offset:]
            vals, cols = vals.view(nb, rb, width), cols.view(nb, rb, width)
            nnz = torch.randint(-2, width + 3, (nb, rb), device="cuda",
                                generator=gen, dtype=torch.int32)
            nnz[0, :5] = torch.tensor([0, 1, -1, width, width + 7])
            x = torch.randn((n_cols,), device="cuda", generator=gen).to(dtype)
            args = (vals, cols, nnz, x)
            aligned = (vals.data_ptr() | cols.data_ptr()) % 16 == 0
            for predicated, fn, plain in (
                    (True, spmv.spmv_blockell, spmv.spmv_blockell_plain),
                    (False, spmv.spmv_fixed_width,
                     spmv.spmv_fixed_width_plain)):
                got = fn(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err, ok = spmv_close(torch, got, want, spmv_scale(
                    spmv_ref, *args, predicated=predicated))
                plan = spmv.spmv_plan(width, dtype, predicated, aligned)
                cases.append({"variant": "predicated" if predicated
                              else "fixed_width", "dtype": dtype_name(dtype),
                              "width": width, "offset": offset,
                              "plan": plan._asdict(), "max_abs_err": err,
                              "ok": ok and fn.last_plan == plan})
    return cases


def hpc_problems(torch):
    """The full-size inputs of the four kernels, made on the card from
    seeded generators."""
    from repro_torch.kernels.spmv import ref as spmv_ref

    gen = torch.Generator(device="cuda").manual_seed(21)
    kw = dict(device="cuda", generator=gen)
    vals, cols, nnz = spmv_ref.make_problem(
        SPMV_ROWS, SPMV_ROWS, row_block=8, max_nnz=SPMV_MAX_NNZ,
        width_pad=SPMV_WIDTH, generator=gen, device="cuda")
    x, y = (torch.randn((GEMM_N, GEMM_N), **kw) for _ in range(2))
    return {
        "stream": (torch.randn(STREAM_SHAPE, **kw),
                   torch.randn(STREAM_SHAPE, **kw)),
        "gemm": (x, y),
        "gemm_bf16": (x.bfloat16(), y.bfloat16()),
        "jacobi": (torch.randn((JACOBI_N, JACOBI_N), **kw),),
        "spmv": (vals, cols, nnz, torch.randn((SPMV_ROWS,), **kw)),
    }


def hpc_timing(torch, problems):
    """Each kernel at full size: held against its plain version, then
    device ms (median of CUDA events) of the kernel, the plain version and
    one PyTorch library call computing the same function, beside the
    least time at the H100's peaks.  Returns {kernel: row}."""
    from repro_torch.kernels.gemm import ref as gemm_ref
    from repro_torch.kernels.jacobi2d import ref as jacobi_ref
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.stream import ref as stream_ref

    gemm, jacobi, spmv, stream = hpc_modules()
    rows = {}

    a, b = problems["stream"]
    c = torch.empty_like(a)
    q = STREAM_Q
    library = {"copy": lambda: c.copy_(a),
               "scale": lambda: torch.mul(a, q, out=c),
               "add": lambda: torch.add(a, b, out=c),
               "triad": lambda: torch.add(a, b, alpha=q, out=c)}
    for op in STREAM_OPS:
        args = {"copy": (a,), "scale": (a, q), "add": (a, b),
                "triad": (a, b, q)}[op]
        kern = getattr(stream, f"stream_{op}")
        plain = getattr(stream, f"stream_{op}_plain")
        want = plain(*args)
        err, ok, bit = exact_close(torch, kern(*args), want)
        require(ok, f"stream {op} kernel != plain at full size: {err}")
        library[op]()
        require(torch.allclose(c, want, rtol=1e-6, atol=1e-6),
                f"stream {op} library yardstick disagrees")
        del want
        bound_ms, bound_by = bound(stream_ref.work_terms(op, a), "float32")
        rows[f"stream_{op}"] = {
            "max_abs_err": err, "bit_equal": bit,
            "ms": device_ms(torch, lambda: kern(*args), reps=30),
            "plain_ms": device_ms(torch, lambda: plain(*args), reps=30),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(torch, library[op], reps=30)}
        emit({"phase": "timing", "kernel": f"stream_{op}",
              "shape": list(STREAM_SHAPE), "dtype": "float32",
              **rows[f"stream_{op}"]})
    del c

    for row, route in (("gemm", "simt"), ("gemm_bf16", "wgmma")):
        rows[row] = gemm_timing(torch, gemm, gemm_ref, *problems[row], route)
        emit({"phase": "timing", "kernel": row, "shape": [GEMM_N] * 3,
              "tf32": torch.backends.cuda.matmul.allow_tf32, **rows[row]})

    (u,) = problems["jacobi"]
    err, ok, bit = exact_close(torch, jacobi.jacobi_step(u),
                               jacobi.jacobi_step_plain(u))
    require(ok, f"jacobi kernel != plain at full size: {err}")
    bound_ms, bound_by = bound(jacobi_ref.work_terms(u), "float32")
    rows["jacobi_step"] = {
        "max_abs_err": err, "bit_equal": bit,
        "ms": device_ms(torch, lambda: jacobi.jacobi_step(u), reps=30),
        "plain_ms": device_ms(torch, lambda: jacobi.jacobi_step_plain(u),
                              reps=30),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit({"phase": "timing", "kernel": "jacobi_step",
          "shape": [JACOBI_N, JACOBI_N], "dtype": "float32",
          **rows["jacobi_step"]})

    vals, cols, nnz, xs = problems["spmv"]
    width = vals.shape[-1]
    live = torch.arange(width, device="cuda") < nnz[..., None]
    counts = nnz.reshape(-1).long().clamp(0, width)
    crow = torch.zeros(counts.numel() + 1, dtype=torch.int64, device="cuda")
    crow[1:] = counts.cumsum(0)
    # the library's matrix of each workload: the predicated one holds each
    # row's live lanes, the fixed-width one every lane of the width
    csrs = {True: torch.sparse_csr_tensor(crow, cols[live].long(),
                                          vals[live],
                                          size=(SPMV_ROWS, SPMV_ROWS)),
            False: torch.sparse_csr_tensor(
                torch.arange(0, SPMV_ROWS * width + 1, width,
                             dtype=torch.int64, device="cuda"),
                cols.reshape(-1).long(), vals.reshape(-1),
                size=(SPMV_ROWS, SPMV_ROWS))}
    xcol = xs[:, None]
    for variant, kern, plain, predicated in (
            ("spmv_blockell", spmv.spmv_blockell, spmv.spmv_blockell_plain,
             True),
            ("spmv_fixed_width", spmv.spmv_fixed_width,
             spmv.spmv_fixed_width_plain, False)):
        want = plain(vals, cols, nnz, xs)
        scale = spmv_scale(spmv_ref, vals, cols, nnz, xs,
                           predicated=predicated)
        err, ok = spmv_close(torch, kern(vals, cols, nnz, xs), want, scale)
        require(ok, f"{variant} kernel != plain at full size: {err}")
        csr = csrs[predicated]
        lib_err, lib_ok = spmv_close(
            torch, torch.sparse.mm(csr, xcol)[:, 0], want, scale)
        require(lib_ok, f"{variant} library yardstick disagrees: {lib_err}")
        bound_ms, bound_by = bound(
            spmv_ref.work_terms(vals, nnz, xs, predicated=predicated),
            "float32")
        probe = spmv.spmv_gather_probe(nnz, xs, width, predicated=predicated)
        probe_err, probe_ok = spmv_close(
            torch, probe,
            spmv_ref.gather_probe_plain(nnz, xs, width,
                                        predicated=predicated),
            spmv_ref.gather_probe_plain(nnz, xs.abs(), width,
                                        predicated=predicated))
        require(probe_ok, f"{variant} gather probe != plain: {probe_err}")
        rows[variant] = {
            "max_abs_err": err, "plan": kern.last_plan._asdict(),
            "gathers": int(counts.sum()) if predicated else vals.numel(),
            "gather_floor_ms": device_ms(
                torch, lambda: spmv.spmv_gather_probe(
                    nnz, xs, width, predicated=predicated), reps=50),
            "ms": device_ms(torch, lambda: kern(vals, cols, nnz, xs),
                            reps=50),
            "plain_ms": device_ms(torch, lambda: plain(vals, cols, nnz, xs),
                                  reps=30),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(torch,
                                    lambda: torch.sparse.mm(csr, xcol),
                                    reps=50),
            "library_nnz": int(csr.values().numel())}
        emit({"phase": "timing", "kernel": variant,
              "rows": SPMV_ROWS, "width": width, "max_nnz": SPMV_MAX_NNZ,
              "nnz": int(counts.sum()), "dtype": "float32",
              "gather_probe_err": probe_err, **rows[variant]})
    return rows


def gemm_timing(torch, gemm, gemm_ref, x, y, route):
    """The GEMM at full size in x's dtype: held against its plain version
    and run by ``route`` (the route counter says so), then kernel, plain
    and ``torch.matmul`` ms beside the least time at the dtype's peak."""
    dtype = dtype_name(x.dtype)
    want = gemm.gemm_plain(x, y)
    before = dict(gemm.gemm.route_launches)
    err, ok = gemm_close(torch, gemm.gemm(x, y), want)
    ran = gemm_route(gemm, before)
    require(ok, f"gemm {dtype} kernel != plain at full size: {err}")
    require(ran == route, f"gemm {dtype} ran route {ran}, not {route}")
    lib_err, lib_ok = gemm_close(torch, torch.matmul(x, y), want)
    require(lib_ok, f"gemm {dtype} library yardstick disagrees: {lib_err}")
    del want
    bound_ms, bound_by = bound(gemm_ref.work_terms(x, y), dtype)
    reps = 5 if dtype == "float32" else 20
    return {
        "dtype": dtype, "gemm_route": ran, "max_abs_err": err,
        "ms": device_ms(torch, lambda: gemm.gemm(x, y), reps=reps, warmup=2),
        "plain_ms": device_ms(torch, lambda: gemm.gemm_plain(x, y), reps=5,
                              warmup=2),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(torch, lambda: torch.matmul(x, y), reps=reps,
                                warmup=2)}


def hpc_workloads(torch, problems):
    """(workload, least work, dtype name) of the four kernels at full size
    as ad-hoc Workloads, with the reference's analytic models (STREAM's
    four ops, GEMM in fp32 and bf16, that is on each of its routes, and
    SpMV's predicated and fixed-width entry points)."""
    from repro_torch.analysis import Workload
    from repro_torch.kernels import registry
    from repro_torch.kernels.gemm import ref as gemm_ref
    from repro_torch.kernels.jacobi2d import ref as jacobi_ref
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.stream import ref as stream_ref

    out = []
    a, b = problems["stream"]
    for op in STREAM_OPS:
        fb = stream_ref.flops_bytes(op, a.numel(), 4)
        args = {"copy": (a,), "scale": (a, STREAM_Q), "add": (a, b),
                "triad": (a, b, STREAM_Q)}[op]
        out.append((Workload(
            name=f"full/stream-{op}", fn=registry.get_kernel(f"stream-{op}"),
            args=args, flops=fb["flops"], hbm_bytes=fb["bytes"],
            problem="2^21x128"), stream_ref.work_terms(op, a), "float32"))
    for name, key, dtype in (("full/gemm", "gemm", "fp32"),
                             ("full/gemm-bf16", "gemm_bf16", "bf16")):
        x, y = problems[key]
        fb = gemm_ref.flops_bytes(GEMM_N, GEMM_N, GEMM_N, x.element_size())
        out.append((Workload(name=name, fn=registry.GEMM, args=(x, y),
                             dtype=dtype, flops=fb["flops"],
                             hbm_bytes=fb["bytes"], problem=f"{GEMM_N}^3"),
                    gemm_ref.work_terms(x, y), dtype_name(x.dtype)))
    (u,) = problems["jacobi"]
    fb = jacobi_ref.flops_bytes(JACOBI_N, JACOBI_N, 4)
    out.append((Workload(name="full/jacobi2d", fn=registry.JACOBI_STEP,
                         args=(u,), flops=fb["flops"], hbm_bytes=fb["bytes"],
                         problem=f"{JACOBI_N}^2"),
                jacobi_ref.work_terms(u), "float32"))
    vals, cols, nnz, xs = problems["spmv"]
    for name, fn, entries, predicated in (
            ("full/spmv", registry.SPMV,
             float(nnz.clamp(0, vals.shape[-1]).sum()), True),
            ("full/spmv-fixed-width", registry.SPMV_FIXED,
             float(vals.numel()), False)):
        out.append((Workload(
            name=name, fn=fn, args=(vals, cols, nnz, xs),
            flops=2.0 * entries, hbm_bytes=entries * 12.0,
            gather_bytes=entries * 4.0, problem="2^20^2 zipf"),
            spmv_ref.work_terms(vals, nnz, xs, predicated=predicated),
            "float32"))
    return out


# -- the last kernels: the RX gate and the contiguous flash-decode -------------

RX_FULL_QUBITS = 28            # two 1 GiB fp32 planes in, two out
RX_TIMED_QUBITS = (0, 5, 13, 27)
RX_LAYER_QUBITS = (21, 28)     # the paper's problem (fits the L2) and full
RX_THETA = 1.1
DENSE_B, DENSE_S = 32, 4096
TPU_QC = "src/repro/kernels/qc_gate/kernel.py"


def rx_equal(torch, got, want):
    """(max abs err, bit-equal) of two (re, im) results."""
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return err, all(torch.equal(g, w) for g, w in zip(got, want))


def check_rx_gate(torch, np):
    """The RX gate against its plain version on the card, in fp32 and
    bf16: both round every product, sum and difference to the planes'
    dtype, so they must be bit-equal; fp32 results up to 2^12 amplitudes
    also within 1e-5 of the complex128 oracle (the reference's own
    tolerance)."""
    import math

    from repro_torch.kernels.qc_gate import kernel as qc
    from repro_torch.kernels.qc_gate import ref as qc_ref

    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n in (6, 12, 22):
            re, im = (torch.randn((1 << n,), device="cuda",
                                  generator=gen).to(dtype) for _ in range(2))
            for qubit in sorted({0, 1, 4, 5, n - 1}):
                for theta in (0.25, 1.1, 2 * math.pi):
                    got = qc.rx_gate(re, im, qubit, theta)
                    want = qc.rx_gate_plain(re, im, qubit, theta)
                    torch.cuda.synchronize()
                    err, bit = rx_equal(torch, got, want)
                    case = {"dtype": dtype_name(dtype), "qubits": n,
                            "qubit": qubit, "theta": theta,
                            "max_abs_err": err, "bit_equal": bit, "ok": bit}
                    if dtype == torch.float32 and n <= 12:
                        oracle = qc_ref.rx_ref(re, im, qubit, theta)
                        case["oracle_err"] = max(
                            float(np.abs(g.cpu().numpy() - o).max())
                            for g, o in zip(got, oracle))
                        case["ok"] = bit and case["oracle_err"] <= 1e-5
                    cases.append(case)
    report_cases("kernel-dense", "rx_gate", cases)


def check_flash_decode(torch, np):
    """The contiguous flash-decode against its plain version on the card:
    D 16/32/64/128, G 1/2/4/8, fp32 and bf16, 6 slots of 300 rows (tiles
    of 64 with a ragged last one) with lengths 0 (zeros out), 1, S, a tile
    edge and two drawn ones.  The K/V rows past each length are then
    poisoned with 1e4 / NaN: the output must not change by a bit."""
    from repro_torch.kernels.flash_decode import kernel as fd

    B, KV, S = 6, 2, 300
    rng = np.random.default_rng(41)
    valid = rng.integers(1, S + 1, size=B)
    valid[:4] = (0, 1, S, fd.DECODE_TILE)
    gen = torch.Generator(device="cuda").manual_seed(42)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    live = torch.arange(S, device="cuda")[None, :] < vl[:, None]   # (B, S)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        tol = TOLERANCE[name]
        for D in (16, 32, 64, 128):
            for G in (1, 2, 4, 8):
                q = torch.randn((B, KV, G, D), device="cuda",
                                generator=gen).to(dtype)
                k, v = (torch.randn((B, S, KV, D), device="cuda",
                                    generator=gen).to(dtype)
                        for _ in range(2))
                out = fd.flash_decode(q, k, v, vl)
                want = fd.flash_decode_plain(q, k, v, vl)
                k2, v2 = k.clone(), v.clone()
                k2[~live] = 1e4
                v2[~live] = float("nan")
                poisoned = fd.flash_decode(q, k2, v2, vl)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                close = torch.allclose(out.float(), want.float(), atol=tol,
                                       rtol=tol)
                inert = torch.equal(poisoned, out)
                empty = not out[0].any().item()
                cases.append({"dtype": name, "D": D, "G": G,
                              "max_abs_err": err, "tol": tol,
                              "poisoned_tail_inert": inert,
                              "empty_slot_zeros": empty,
                              "ok": bool(close and inert and empty)})
    emit({"phase": "kernel-dense", "kernel": "flash_decode", "B": B,
          "KV": KV, "S": S, "valid_len": valid.tolist()})
    report_cases("kernel-dense", "flash_decode", cases)


def rx_timing(torch):
    """The RX gate at 28 qubits on qubits 0, 5, 13 and 27, and the RX layer
    (one gate a qubit) at 21 and 28 qubits, fp32: kernel and plain ms
    beside the least time at the H100's peaks (each plane read once and
    written once); no single PyTorch call computes a gate.  Returns (rows
    by qubit, rows by layer size)."""
    from repro_torch.kernels.qc_gate import kernel as qc
    from repro_torch.kernels.qc_gate import ops as qc_ops
    from repro_torch.kernels.qc_gate import ref as qc_ref

    gen = torch.Generator(device="cuda").manual_seed(33)
    re, im = (torch.randn((1 << RX_FULL_QUBITS,), device="cuda",
                          generator=gen) for _ in range(2))
    gates = {}
    for qubit in RX_TIMED_QUBITS:
        def kern(q=qubit):
            return qc.rx_gate(re, im, q, RX_THETA)

        def plain(q=qubit):
            return qc.rx_gate_plain(re, im, q, RX_THETA)

        err, bit = rx_equal(torch, kern(), plain())
        require(bit, f"rx_gate != plain at 28 qubits, qubit {qubit}: {err}")
        bound_ms, bound_by = bound(qc_ref.work_terms(re), "float32")
        gates[qubit] = {"max_abs_err": err, "bit_equal": bit,
                        "ms": device_ms(torch, kern, reps=20),
                        "plain_ms": device_ms(torch, plain, reps=5,
                                              warmup=2),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None}
        emit({"phase": "timing-dense", "kernel": "rx_gate",
              "qubits": RX_FULL_QUBITS, "qubit": qubit, "dtype": "float32",
              **gates[qubit]})
    layers = {}
    for n in RX_LAYER_QUBITS:
        r, i = re[: 1 << n], im[: 1 << n]

        def kern(n=n, r=r, i=i):
            return qc_ops.rx_layer(r, i, n, RX_THETA)

        def plain(n=n, r=r, i=i):
            for q in range(n):
                r, i = qc.rx_gate_plain(r, i, q, RX_THETA)
            return r, i

        err, bit = rx_equal(torch, kern(), plain())
        require(bit, f"rx_layer != plain at {n} qubits: {err}")
        reps = 20 if n < RX_FULL_QUBITS else 3
        bound_ms, bound_by = bound(qc_ref.work_terms(r, gates=n), "float32")
        layers[n] = {"max_abs_err": err, "bit_equal": bit,
                     "ms": device_ms(torch, kern, reps=reps, warmup=2),
                     "plain_ms": device_ms(torch, plain, reps=3, warmup=1),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
        emit({"phase": "timing-dense", "kernel": "rx_layer", "qubits": n,
              "gates": n, "dtype": "float32", "state_bytes": 8 << n,
              **layers[n]})
    return gates, layers


def decode_close(torch, got, want):
    """The decode against its plain version: fp32 accumulators summed in
    another order (atol = rtol = 1e-5, the fp32 tolerance), then one
    rounding to the output's dtype (one ulp of it in bf16).  Returns (max
    abs err, ok)."""
    err = (got.float() - want.float()).abs()
    tol = 1e-5 + 1e-5 * want.float().abs()
    if got.dtype != torch.float32:
        tol = tol + ulp(torch, want, got.dtype)
    return err.max().item(), bool((err <= tol).all())


def decode_problem(torch, np, heads, lengths, seed):
    """bf16 q, k, v of 32 slots of 4096 rows with ``heads`` (KV, G, D),
    made on the card; lengths uniform in [1, S] ("ragged") or all S."""
    KV, G, D = heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", generator=gen)
    valid = (np.random.default_rng(seed).integers(1, DENSE_S + 1,
                                                  size=DENSE_B)
             if lengths == "ragged" else np.full(DENSE_B, DENSE_S))
    q = torch.randn((DENSE_B, KV, G, D), **kw).to(torch.bfloat16)
    k, v = (torch.randn((DENSE_B, DENSE_S, KV, D), **kw).to(torch.bfloat16)
            for _ in range(2))
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    return (q, k, v, vl), valid


def flash_decode_timing(torch, np):
    """The contiguous flash-decode in bf16 at 32 slots of 4096 rows, for
    the heads of each of :data:`ARCH_HEADS`, with lengths uniform in [1, S] and
    all at S: kernel, plain and library ms beside the least time for the
    live rows.  The library yardstick is one SDPA call with a boolean
    length mask on K/V transposed (and repeated per query head) before
    the timed calls.  Returns {(arch, lengths): row}."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref as fd_ref

    rows = {}
    for arch, heads in ARCH_HEADS.items():
        KV, G, D = heads
        for lengths in ("ragged", "full"):
            args, valid = decode_problem(torch, np, heads, lengths, seed=61)
            q, k, v, vl = args
            out = fd.flash_decode(*args)
            want = fd.flash_decode_plain(*args)
            err, ok = decode_close(torch, out, want)
            rms = want.float().pow(2).mean().sqrt().item()
            require(ok, f"flash_decode != plain at {arch} {lengths}: {err}")
            del want
            # the same data in fp32, held at the fp32 tolerance
            args32 = [x.float() if x.is_floating_point() else x
                      for x in args]
            err32, ok32 = decode_close(torch, fd.flash_decode(*args32),
                                       fd.flash_decode_plain(*args32))
            require(ok32, f"flash_decode != plain at {arch} {lengths} in "
                          f"fp32: {err32}")
            del args32
            qh = q.reshape(DENSE_B, KV * G, 1, D)
            kh, vh = (x.transpose(1, 2).repeat_interleave(G, dim=1)
                      .contiguous() for x in (k, v))
            mask = (torch.arange(DENSE_S, device="cuda")[None, :]
                    < vl[:, None])[:, None, None, :]

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)

            lib_err = (library().reshape(out.shape).float()
                       - out.float()).abs().max().item()
            require(lib_err <= 2 * TOLERANCE["bfloat16"],
                    f"SDPA yardstick disagrees: {lib_err}")
            bound_ms, bound_by = bound(fd_ref.decode_work_terms(q, k, valid),
                                       "bfloat16")
            row = {"max_abs_err": err, "err_over_rms": err / rms,
                   "fp32_max_abs_err": err32,
                   "ms": device_ms(torch, lambda: fd.flash_decode(*args),
                                   reps=30),
                   "plain_ms": device_ms(
                       torch, lambda: fd.flash_decode_plain(*args), reps=10),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": device_ms(torch, library, reps=30)}
            rows[arch, lengths] = row
            emit({"phase": "timing-dense", "kernel": "flash_decode",
                  "arch_heads": arch, "lengths": lengths, "B": DENSE_B,
                  "S": DENSE_S, "KV": KV, "G": G, "D": D,
                  "dtype": "bfloat16", "live_rows": int(valid.sum()),
                  "tile_issues": fd_ref.issue_counts(valid, DENSE_S,
                                                     fd.DECODE_TILE),
                  **row})
        emit({"phase": "timing-dense", "kernel": "flash_decode",
              "arch_heads": arch,
              "full_over_ragged_ms": (rows[arch, "full"]["ms"]
                                      / rows[arch, "ragged"]["ms"])})
    return rows


def check_registry_workloads(torch):
    """The registry's qc-gate, flash-decode and flash-prefill workloads as
    the analysis phase runs them on the card (the workload's function on
    its example arguments, moved to the card), against the op's plain
    version on a second copy of the same arguments: the RX gate bit-equal,
    the attention outputs within 1e-5 (fp32), and the pools the prefill
    commits bit-equal."""
    from repro_torch.analysis import get_workload
    from repro_torch.kernels import registry

    plain = {"kernel/qc-gate": (registry.RX_GATE, dict(qubit=0, theta=0.25)),
             "kernel/flash-decode": (registry.FLASH_DECODE,
                                     dict(block_s=16)),
             "kernel/flash-prefill": (registry.FLASH_PREFILL,
                                      dict(block_c=8))}
    cases = []
    for name, (op, kw) in plain.items():
        wl = get_workload(name)
        got_args, want_args = ([a.to("cuda", copy=True)
                                for a in wl.example_args()]
                               for _ in range(2))
        got = wl.fn(*got_args)
        want = op.interpret(*want_args, **kw)
        torch.cuda.synchronize()
        case = {"workload": name, "problem": wl.problem}
        if name == "kernel/qc-gate":
            err, bit = rx_equal(torch, got, want)
            case.update(max_abs_err=err, bit_equal=bit, ok=bit)
        else:
            if name == "kernel/flash-prefill":
                # the kernel commits into got_args' pools in place
                pools = (torch.equal(got_args[3], want[1])
                         and torch.equal(got_args[4], want[2]))
                case["pools_equal"] = pools
                want = want[0]
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
            case.update(max_abs_err=err, tol=1e-5,
                        bit_equal=bool(torch.equal(got, want)),
                        ok=bool(ok and case.get("pools_equal", True)))
        cases.append(case)
    report_cases("kernel-dense", "registry workloads", cases)


def dense_workloads(torch, np):
    """(workload, least work, dtype name) of this slice's analysis path:
    the RX layer at 28 qubits (the paper's circuit driver), the
    flash-decode at full size (qwen3-1.7b heads, ragged), and the
    registry's qc-gate, flash-decode and flash-prefill workloads at the
    reference's sizes, with the reference's analytic models."""
    from repro_torch.analysis import Workload, get_workload
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_decode import ref as fd_ref
    from repro_torch.kernels.qc_gate import ops as qc_ops
    from repro_torch.kernels.qc_gate import ref as qc_ref

    n = RX_FULL_QUBITS
    gen = torch.Generator(device="cuda").manual_seed(71)
    re, im = (torch.randn((1 << n,), device="cuda", generator=gen)
              for _ in range(2))
    fb = qc_ref.flops_bytes(n, 4)
    out = [(Workload(name="full/qc-gate",
                     fn=lambda r, i: qc_ops.rx_layer(r, i, n, RX_THETA),
                     args=(re, im), dtype="fp32", flops=n * fb["flops"],
                     hbm_bytes=n * fb["bytes"],
                     problem=f"{n} qubits, RX on each"),
            qc_ref.work_terms(re, gates=n), "float32")]
    KV, G, D = ARCH_HEADS["qwen3-1.7b"]
    args, valid = decode_problem(torch, np, (KV, G, D), "ragged", seed=72)
    fb = fd_ref.flops_bytes(DENSE_B, KV, G, D, valid, dtype_bytes=2)
    out.append((Workload(name="full/flash-decode", fn=registry.FLASH_DECODE,
                         args=args, dtype="bf16", flops=fb["flops"],
                         hbm_bytes=fb["bytes"],
                         problem=f"B{DENSE_B} KV{KV} G{G} D{D} S{DENSE_S} "
                                 f"ragged"),
                fd_ref.decode_work_terms(args[0], args[1], valid),
                "bfloat16"))
    wl = get_workload("kernel/qc-gate")
    out.append((wl, qc_ref.work_terms(wl.example_args()[0]), "float32"))
    wl = get_workload("kernel/flash-decode")
    q, k, _, vl = wl.example_args()
    out.append((wl, fd_ref.decode_work_terms(q, k, vl.tolist()), "float32"))
    wl = get_workload("kernel/flash-prefill")
    q, _, _, kp, _, bt, qs = wl.example_args()
    B, C = q.shape[:2]
    out.append((wl, fd_ref.prefill_work_terms(q, kp, bt, qs.tolist(),
                                              [C] * B), "float32"))
    return out


def phase_analysis(torch, np, problems):
    """The paper's method through its service entry point: the full-size
    workloads and this slice's (:func:`dense_workloads`) on the h100 and
    grace-core models, each ROI timed on the card (jobs 1).  The launch
    counts are set to 0 just before the drain and read just after: every
    kernel of the suite runs.  The share of the H100's roofline attained
    (least time for the least bytes or flops, over wall_s) above 1.05
    fails the run."""
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.qc_gate import kernel as qc
    from repro_torch.serve.analysis_service import AnalysisService

    workloads = hpc_workloads(torch, problems) + dense_workloads(torch, np)
    svc = AnalysisService(max_batch=8, jobs=1, device="cuda")
    for wl, _, _ in workloads:
        svc.submit(wl, chips=("h100", "grace-core"), time_roi=True)
    entries = {**hpc_entries(), "rx_gate": qc.rx_gate,
               "flash_decode": fd.flash_decode,
               "flash_prefill_paged": fd.flash_prefill_paged}
    routes = entries["gemm"].route_launches
    for fn in entries.values():
        fn.launches = 0
    routes.update(dict.fromkeys(routes, 0))
    torch.cuda.synchronize()
    svc.run_until_drained()
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in entries.items()}
    counts.update({f"gemm_{route}": n for route, n in routes.items()})
    report = svc.report()
    require(report["service"]["errors"] == 0,
            f"analysis errors: {[r['error'] for r in report['requests']]}")
    require(report["service"]["cells"] == 2 * len(workloads),
            f"{report['service']['cells']} cells")
    require(all(n > 0 for n in counts.values()),
            f"a kernel of the path never launched: {counts}")
    least = {wl.name: (terms, dtype) for wl, terms, dtype in workloads}
    cells = []
    for req in svc.completed.values():
        for res in req.results:
            wall = res.wall_s
            require(wall is not None and wall > 0, f"{res.workload} wall_s")
            bound_ms, bound_by = bound(*least[res.workload])
            share = bound_ms / 1e3 / wall
            cells.append({"workload": res.workload, "chip": res.chip,
                          "dtype": res.dtype,
                          "class": int(res.perf_class),
                          "class_name": res.perf_class.name,
                          "ai": res.ai, "knee": res.ai_inflection,
                          "region": res.bound, "vb": res.vb,
                          "r_ins": res.r_ins, "wall_s": wall,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "roofline_share": share})
            require(share <= 1.05,
                    f"{res.workload}: {share:.3f} of the H100 roofline, "
                    f"above 1.05")
    emit({"phase": "analysis", "cells": cells, "launches": counts,
          "waves": report["service"]["waves"],
          "wall_s": report["service"]["wall_s"]})
    return counts, report, cells


#: Fig. 8 classes of the vectorization_report workloads on h100 and on
#: grace-core, as ``tests/test_torch_compiled_events.py`` pins them
EXAMPLE_CLASSES = {"gemm-512": 4, "stream-triad": 2, "gather-reduce": 3,
                   "scan-8-layers": 4, "fft2d": 2}

#: the entry points the registry's kernel workloads launch
REGISTRY_KERNELS = ("gemm", "stream_triad", "spmv_blockell", "jacobi_step",
                    "rx_gate", "flash_decode", "flash_prefill_paged")

#: the second drain: the service CLI over the same store, with the
#: example's workloads registered first (the CLI serves registered names)
SECOND_DRAIN = """
import sys
from repro_torch.analysis import list_workloads, register
from repro_torch.examples import vectorization_report
from repro_torch.serve import analysis_service
examples = vectorization_report.build_workloads()
for wl in examples:
    register(wl, replace=True)
names = list_workloads(tags=("kernel",)) + [wl.name for wl in examples]
sys.exit(analysis_service.main([
    "--device", "cuda", "--source", "compiled", "--store-dir", sys.argv[1],
    "--chips", "h100", "grace-core", "--max-batch", "16",
    "--workloads", *names, "--out", sys.argv[2]]))
"""


def phase_analysis_compiled(torch):
    """The compiled event source (see the module docstring's
    ``analysis-compiled``).  Recordings run on the CPU; the ROIs, timed on
    the card, launch the kernels: their counts are set to 0 just before
    the drain and read just after."""
    import os
    import tempfile

    from repro_torch.analysis import list_workloads
    from repro_torch.examples import vectorization_report
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.qc_gate import kernel as qc
    from repro_torch.serve.analysis_service import AnalysisService

    t0 = time.time()
    workloads = (list_workloads(tags=("kernel",))
                 + vectorization_report.build_workloads())
    chips = ("h100", "grace-core")
    entries = {**hpc_entries(), "rx_gate": qc.rx_gate,
               "flash_decode": fd.flash_decode,
               "flash_prefill_paged": fd.flash_prefill_paged}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-store-") as store:
        svc = AnalysisService(max_batch=16, jobs=1, device="cuda",
                              store=store)
        for wl in workloads:
            svc.submit(wl, chips=chips, source="compiled", time_roi=True)
        for name in REGISTRY_KERNELS:
            entries[name].launches = 0
        torch.cuda.synchronize()
        svc.run_until_drained()
        torch.cuda.synchronize()
        counts = {name: entries[name].launches for name in REGISTRY_KERNELS}
        first = svc.report()
        service = first["service"]
        require(service["errors"] == 0,
                f"analysis-compiled errors: "
                f"{[r['error'] for r in first['requests'] if r['error']]}")
        require(service["cells"] == 2 * len(workloads),
                f"{service['cells']} cells")
        require(service["compiles"] == len(workloads)
                and service["store_hits"] == 0,
                f"first drain: {service['compiles']} recordings, "
                f"{service['store_hits']} store hits")
        require(all(n > 0 for n in counts.values()),
                f"a registry kernel never launched in the ROIs: {counts}")
        results = [res for req in first["requests"] for res in req["results"]]
        classes = {(r["workload"], r["chip"]): r["perf_class"]
                   for r in results}
        for name, cls in EXAMPLE_CLASSES.items():
            for chip in chips:
                require(classes[name, chip] == cls,
                        f"{name}@{chip}: class {classes[name, chip]}, "
                        f"the CPU tests pin {cls}")
        first_s = time.time() - t0
        out = os.path.join(store, "second.json")
        proc = subprocess.run(
            [sys.executable, "-c", SECOND_DRAIN, store, out],
            capture_output=True, text=True, timeout=300, cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(SRC)})
        require(proc.returncode == 0,
                f"second drain exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        with open(out) as f:
            second = json.load(f)

    again = second["service"]
    require(again["compiles"] == 0
            and again["store_hits"] == len(workloads),
            f"second drain: {again['compiles']} recordings, "
            f"{again['store_hits']} store hits")

    def strip(report):
        return [{k: v for k, v in res.items() if k != "wall_s"}
                for req in report["requests"] for res in req["results"]]

    require(strip(second) == strip(first),
            "second drain's results differ from the first's")
    emit({"phase": "analysis-compiled",
          "cells": [{"workload": r["workload"], "chip": r["chip"],
                     "class": r["perf_class"], "flops": r["flops"],
                     "hbm_bytes": r["hbm_bytes"],
                     "mxu_flops": r["events"]["mxu_flops"],
                     "wall_s": r["wall_s"]} for r in results],
          "classes_h100": {r["workload"]: r["perf_class"] for r in results
                           if r["chip"] == "h100"},
          "launches": counts,
          "recordings": service["compiles"],
          "record_s": svc.cache.record_s,
          "first_drain_s": first_s,
          "second_drain": {"recordings": again["compiles"],
                           "store_hits": again["store_hits"],
                           "wall_s": again["wall_s"]},
          "seconds": time.time() - t0})


# -- the paper's application suite, its driver and the quickstart -------------


#: the card against the CPU, per app, with the CPU tests' bounds
#: (``tests/test_torch_suite_apps.py``, port against reference): rtol, and
#: atol as a share of the CPU output's largest magnitude.  LLM-training:
#: its loss at rtol 1e-5, grad norm at 1e-4, params at rtol 1e-4 and atol
#: 1e-5 (``parity-train``'s).
SUITE_TOL = {
    "LLM-inference": (1e-4, 1e-5), "QC-simulator": (0.0, 0.0),
    "FFT1D": (1e-5, 4e-6), "FFT2D": (1e-5, 4e-6), "STREAM": (0.0, 0.0),
    "DGEMM": (1e-5, 4e-6), "SGEMM": (2.0 ** -8, 2.0 ** -8),
    "SpMV": (1e-5, 1e-6), "Jacobi2D": (0.0, 0.0), "YOLOv3": (1e-5, 4e-6),
    "AlexNet": (1e-5, 4e-6), "AutoDock": (1e-5, 0.0)}
#: the apps at the paper's sizes: (builder, its argument, what it builds)
SUITE_PAPER = (("_qc_app", 21, "QC at 21 qubits"),
               ("_stream_app", 1024, "STREAM at 1024 MB"),
               ("_gemm_apps", 12288, "DGEMM and SGEMM at 12288^2"),
               ("_jacobi_app", 16384, "Jacobi2D at 16384^2"),
               ("_llm_apps", "gpt2-124m", "LLM apps at gpt2-124m FULL"),
               ("_yolo_app", 608, "YOLOv3 at 608^2"))
#: the benchmarks the driver runs on the card, in process
SUITE_DRIVER = ("fig3_vectorization", "table3_decision_tree")


def _outputs(out) -> list:
    from repro_torch.optim.adamw import tree_leaves

    return tree_leaves(list(out) if isinstance(out, tuple) else [out])


def suite_close(torch, name, got, want):
    """(max abs err, ok) of an app's output on the card against the same
    app's on the CPU from the same inputs (:data:`SUITE_TOL`)."""
    if name == "LLM-training":
        (gp, _, gm), (wp, _, wm) = got, want
        scalars_ok = all(
            abs(float(gm[k]) - float(wm[k])) <= rtol * abs(float(wm[k]))
            for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)))
        pairs, ok = list(zip(_outputs(gp), _outputs(wp))), scalars_ok
        tols = [(1e-4, 1e-5)] * len(pairs)
    else:
        pairs, ok = list(zip(_outputs(got), _outputs(want))), True
        rtol, share = SUITE_TOL[name]
        tols = [(rtol, share * w.float().abs().max().item())
                for _, w in pairs]
    err = 0.0
    for (g, w), (rtol, atol) in zip(pairs, tols):
        g, w = g.detach().float().cpu(), w.detach().float()
        ok = ok and g.shape == w.shape
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        ok = ok and bool((diff <= atol + rtol * w.abs()).all())
    return err, ok


def suite_paper_sizes(torch):
    """The apps the paper sizes, each at that size on the card, timed by
    ``measure`` (warm-up, at least 5 repeats, best of), with its AI and
    its share of the H100 roofline (the least time for its analytic flops
    and bytes at the peaks of the dtype it runs in, over the best-of).  QC
    at 21 qubits also one layer with its launches counted (21) and its
    state against 21 passes of the plain gate on the card.  Returns the
    rows and the RX gate's launches."""
    import repro_torch.configs as configs
    from repro_torch.kernels.qc_gate import kernel as qc
    from repro_torch.kernels.qc_gate import ref as qc_ref
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.suite import apps

    rows, launches = [], {}
    for builder, size, what in SUITE_PAPER:
        arg = configs.get_config(size) if builder == "_llm_apps" else size
        built = getattr(apps, builder)(arg)
        for app in (built if isinstance(built, list) else [built]):
            t0 = time.time()
            args = app.args_on(torch.device("cuda"))
            torch.cuda.synchronize()
            draw_s = time.time() - t0
            row = {"app": app.name, "problem": app.problem, "what": what,
                   "draw_s": draw_s}
            if app.name == "QC-simulator":
                qc.rx_gate.launches = 0
                got = app.fn(*args)
                torch.cuda.synchronize()
                launches["layer_21"] = qc.rx_gate.launches
                require(qc.rx_gate.launches == size,
                        f"QC at {size} qubits: {qc.rx_gate.launches} "
                        f"launches of the RX gate, not {size}")
                want = args
                for q in range(size):
                    want = qc.rx_gate_plain(*want, q, 0.25)
                err, bit = rx_equal(torch, got, want)
                require(bit or err <= 1e-6,
                        f"QC at {size} qubits: {err} off 21 plain passes")
                layer_ms, layer_by = bound(
                    qc_ref.work_terms(args[0], gates=size), "float32")
                row.update({"max_abs_err": err, "bit_equal": bit,
                            "layer_bound_ms": layer_ms,
                            "layer_bound_by": layer_by})
                qc.rx_gate.launches = 0
            dtype = dtype_name(tree_leaves(list(args))[0].dtype)
            wall = apps.measure(app, device="cuda")
            if app.name == "QC-simulator":
                launches["measure_21"] = qc.rx_gate.launches
            bound_ms, bound_by = bound(
                {"flops": app.flops, "bytes": app.hbm_bytes}, dtype)
            row.update({"dtype": dtype, "best_ms": wall * 1e3, "ai": app.ai,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "roofline_share": bound_ms / 1e3 / wall,
                        "seconds": time.time() - t0})
            rows.append(row)
            emit({"phase": "suite", "paper_size": row})
        # the apps hold their inputs, on the host and on the card
        del built, app, args
        torch.cuda.empty_cache()
    return rows, launches


def suite_driver(torch, card):
    """``python -m repro_torch.suite.run``'s ``main`` in process, on the
    card with ``--chip h100 --record`` into a fresh ``$REPRO_ARTIFACT_DIR``
    (restored after): Fig. 3 (every app timed on the card), then Table 3;
    then Table 3 with ``--device cpu``.  Each exits 0 and writes its CSV
    and ``summary.json``; the card's summary carries the card's
    ``nvidia-smi`` line; the ledger holds the two card runs in h100/fp32;
    the card's Table 3 equals the CPU's.  Returns (lines, RX launches)."""
    import contextlib
    import csv
    import io
    import os
    import tempfile

    from repro_torch.kernels.qc_gate import kernel as qc
    from repro_torch.perf import default_ledger
    from repro_torch.suite import run as suite_run

    saved = os.environ.get("REPRO_ARTIFACT_DIR")
    lines = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-suite-") as tmp:
        os.environ["REPRO_ARTIFACT_DIR"] = tmp
        try:
            tables = {}
            qc.rx_gate.launches = 0
            for name, device in (*((n, "cuda") for n in SUITE_DRIVER),
                                 ("table3_decision_tree", "cpu")):
                out = os.path.join(tmp, f"{name}-{device}")
                argv = ["--only", name, "--device", device, "--out", out]
                if device == "cuda":
                    argv += ["--chip", "h100", "--record"]
                printed = io.StringIO()
                t0 = time.time()
                with contextlib.redirect_stdout(printed):
                    rc = suite_run.main(argv)
                require(rc == 0, f"suite driver {argv}: exit code {rc}: "
                        f"{printed.getvalue()[-2000:]}")
                with open(os.path.join(out, f"{name}.csv")) as f:
                    tables[name, device] = list(csv.DictReader(f))
                with open(os.path.join(out, "summary.json")) as f:
                    summary = json.load(f)
                require(summary["passed"] == 1 and summary["failed"] == 0,
                        f"suite driver {argv}: summary {summary}")
                if device == "cuda":
                    require(summary["env"]["gpu"] == card
                            and summary["env"]["chip"] == "h100",
                            f"summary env {summary['env']}, nvidia-smi "
                            f"{card!r}")
                lines[f"{name}@{device}"] = {
                    "rc": rc, "rows": len(tables[name, device]),
                    "seconds": time.time() - t0}
            driver_launches = qc.rx_gate.launches
            fig3 = tables["fig3_vectorization", "cuda"]
            require(len(fig3) == 13 and all(
                float(r["wall_s_cuda"]) > 0 for r in fig3),
                f"fig3 on the card: {fig3}")
            card_t3 = tables["table3_decision_tree", "cuda"]
            require(card_t3 == tables["table3_decision_tree", "cpu"]
                    and card_t3[-1]["app"] == "AGREEMENT 13/13",
                    f"Table 3 on the card {card_t3[-1]}, on the CPU "
                    f"{tables['table3_decision_tree', 'cpu'][-1]}")
            runs = default_ledger().runs()
            require([r.env.series_key() for r in runs]
                    == ["h100/fp32", "h100/fp32"],
                    f"ledger runs {[r.env.series_key() for r in runs]}")
        finally:
            if saved is None:
                os.environ.pop("REPRO_ARTIFACT_DIR", None)
            else:
                os.environ["REPRO_ARTIFACT_DIR"] = saved
    lines["agreement"] = card_t3[-1]["app"]
    lines["fig3_wall_s_cuda"] = {r["app"]: float(r["wall_s_cuda"])
                                 for r in fig3}
    return lines, driver_launches


def phase_suite(torch, card):
    """The paper's 13 apps (``repro_torch.suite.apps``) at the reference's
    sizes on the card: each ``analyze(app, chip, time_roi=True,
    device="cuda")`` on grace-core and h100, the launch counts set to 0
    just before and read just after (the QC app's RX gate, kernel 2.9, 16
    launches a layer, two layers a call; no other kernel of the suite
    launches: the other apps run torch ops, as the reference's run jnp);
    then one call of each app on the card against one on the CPU from the
    same inputs (:func:`suite_close`), the QC layer's 16 launches counted;
    then the apps at the paper's sizes (:func:`suite_paper_sizes`) and
    the driver (:func:`suite_driver`).  Returns the RX gate's launches."""
    from repro_torch.analysis import analyze
    from repro_torch.core import hw
    from repro_torch.kernels.qc_gate import kernel as qc
    from repro_torch.suite import apps

    t0 = time.time()
    suite = apps.suite()
    entries = {**hpc_entries(), "rx_gate": qc.rx_gate}
    for fn in entries.values():
        fn.launches = 0
    torch.cuda.synchronize()
    cells = []
    for name, app in suite.items():
        for chip in (hw.GRACE_CORE, hw.H100):
            res = analyze(app, chip, time_roi=True, device="cuda")
            require(res.wall_s is not None and res.wall_s > 0,
                    f"{name}@{chip.name}: wall_s {res.wall_s}")
            cells.append({"app": name, "chip": chip.name,
                          "class": int(res.perf_class), "ai": res.ai,
                          "bound": res.bound, "wall_s": res.wall_s})
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in entries.items()}
    # two ROI calls (warm, timed) of one 16-gate layer on each of two chips
    require(counts["rx_gate"] == 16 * 2 * 2
            and not any(n for k, n in counts.items() if k != "rx_gate"),
            f"suite analysis launches {counts}")
    launches = {"analysis": counts["rx_gate"]}
    parity = {}
    for name, app in suite.items():
        qc.rx_gate.launches = 0
        got = app.fn(*app.args_on(torch.device("cuda")))
        torch.cuda.synchronize()
        if name == "QC-simulator":
            launches["layer_16"] = qc.rx_gate.launches
            require(qc.rx_gate.launches == 16,
                    f"QC layer: {qc.rx_gate.launches} launches, not 16")
        want = app.fn(*app.args_on(torch.device("cpu")))
        err, ok = suite_close(torch, name, got, want)
        parity[name] = {"max_abs_err": err, "ok": ok}
    bad = {n: p for n, p in parity.items() if not p["ok"]}
    require(not bad, f"apps on the card differ from the CPU: {bad}")
    analysis_s = time.time() - t0
    paper_rows, paper_launches = suite_paper_sizes(torch)
    launches.update(paper_launches)
    driver, launches["driver"] = suite_driver(torch, card)
    require(launches["driver"] > 0 and launches["driver"] % 16 == 0,
            f"the driver's Fig. 3 launched the RX gate "
            f"{launches['driver']} times")
    emit({"phase": "suite", "cells": cells, "card_vs_cpu": parity,
          "launches": launches, "analysis_s": analysis_s,
          "paper_sizes": paper_rows, "driver": driver,
          "seconds": time.time() - t0})
    return launches


def phase_quickstart(torch):
    """``repro_torch.examples.quickstart`` twice in process on the card
    against a fresh store: a finite loss each time; the first run records
    the train step (at least one recording), the second records nothing
    and hits the store."""
    import contextlib
    import io
    import math
    import tempfile

    from repro_torch.examples import quickstart

    t0 = time.time()
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-quickstart-") as st:
        for _ in range(2):
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                res = quickstart.run("cuda", st)
            runs.append({"loss": res["loss"], "grad_norm": res["grad_norm"],
                         "recordings": res["recordings"],
                         "store_hits": res["store_hits"],
                         "class": int(res["analysis"].perf_class),
                         "flops": res["analysis"].events.flops,
                         "tail": printed.getvalue().strip().splitlines()[-1]})
    first, second = runs
    require(all(math.isfinite(r["loss"]) for r in runs),
            f"quickstart losses {[r['loss'] for r in runs]}")
    require(first["recordings"] >= 1,
            f"first quickstart run: {first['recordings']} recordings")
    require(second["recordings"] == 0 and second["store_hits"] >= 1,
            f"second quickstart run: {second['recordings']} recordings, "
            f"{second['store_hits']} store hits")
    emit({"phase": "quickstart", "runs": runs,
          "seconds": time.time() - t0})


# -- the autotuner --------------------------------------------------------------


#: the CLI the tuning phase runs twice in a fresh artifact directory
TUNING_CLI = ["-m", "repro_torch.tuning", "--dtypes", "space", "--keep", "2"]


def tuning_wrappers():
    """{registry kernel with a space: the wrapper whose
    ``variant_launches`` counts its launches by variant}."""
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.qc_gate import kernel as qc

    gemm, jacobi, _, stream = hpc_modules()
    wrappers = {"gemm": gemm.gemm}
    wrappers.update({f"stream-{op}": getattr(stream, f"stream_{op}")
                     for op in STREAM_OPS})
    wrappers.update({"jacobi2d": jacobi.jacobi_step, "qc-gate": qc.rx_gate,
                     "flash-decode": fd.flash_decode,
                     "flash-prefill": fd.flash_prefill_paged})
    return wrappers


def variant_key(name, cfg, args):
    """The key a tunable wrapper counts a launch of config ``cfg`` under."""
    if name == "gemm":
        from repro_torch.kernels.gemm import kernel as gemm

        x, y = args[0], args[1]
        plan = gemm.gemm_plan(x.shape[0], y.shape[1], x.shape[1], x.dtype,
                              True, cfg["tile_m"], cfg["tile_n"],
                              cfg["tile_k"], cfg["stages"])
        return (plan.route, *plan.tile, plan.stages)
    if name.startswith("stream"):
        return (cfg["threads"], cfg["vecs"])
    if name == "flash-prefill":
        return (cfg["q_tile"], cfg["key_tile"])
    return next(iter(cfg.values()))


def tuning_examples():
    """{registry kernel: its example arguments on the CPU}: the registry's
    workloads, and the STREAM triad's arrays for the other three ops."""
    from repro_torch.analysis import get_workload

    out = {name: tuple(get_workload(f"kernel/{name}").example_args())
           for name in ("gemm", "stream-triad", "jacobi2d", "qc-gate",
                        "flash-decode", "flash-prefill")}
    a, b, q = out["stream-triad"]
    out.update({"stream-copy": (a,), "stream-scale": (a, q),
                "stream-add": (a, b)})
    return out


def tuning_wide_examples(torch, np):
    """{registry kernel: fp32 arguments on the card} where the registry's
    example cannot tell the variants apart: the contiguous decode at a
    cache of twice the largest ``split_rows`` (so every split is a real
    split), and the prefill at qwen3-1.7b's heads and the serve path's
    block size (the D=128 instantiations a full-size tune times)."""
    from repro_torch.kernels import registry

    KV, G, D = ARCH_HEADS["qwen3-1.7b"]
    S = 2 * max(registry.get_kernel("flash-decode")
                .tuning_space.axes["split_rows"])
    gen = torch.Generator(device="cuda").manual_seed(43)
    kw = dict(device="cuda", generator=gen)
    q = torch.randn((2, KV, G, D), **kw)
    k, v = (torch.randn((2, S, KV, D), **kw) for _ in range(2))
    vl = torch.tensor([S, S // 2 + 77], dtype=torch.int32, device="cuda")
    C, bs, nb = PREFILL_C, KERNEL_BS, PREFILL_NB
    q_start = np.random.default_rng(8).integers(0, nb * bs - C + 1, size=2)
    pre = prefill_inputs(torch, 2, C, KV, G, D, bs, nb, torch.float32,
                         q_start.tolist(), [C, C], seed=9)
    return {"flash-decode": (q, k, v, vl), "flash-prefill": tuple(pre[:7])}


def variant_close(torch, name, got, want):
    """(max abs err, ok) with the tolerance of each kernel's own check."""
    if name == "gemm":
        return gemm_close(torch, got, want)
    if name.startswith("stream") or name == "jacobi2d":
        err, ok, _ = exact_close(torch, got, want)
        return err, ok
    if name == "qc-gate":
        return rx_equal(torch, got, want)
    if name == "flash-decode":
        return decode_close(torch, got, want)
    # the prefill: (out, k_pool, v_pool), outputs at the kernel phase's
    # tolerance and the committed pools bit-equal
    tol = TOLERANCE[dtype_name(got[0].dtype)]
    err = (got[0].float() - want[0].float()).abs().max().item()
    ok = (torch.allclose(got[0].float(), want[0].float(), atol=tol,
                         rtol=tol)
          and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))
    return err, bool(ok)


def check_tuning_variants(torch, np):
    """Every candidate of every space, at the registry's example problem
    (and, for the decode and the prefill, at :func:`tuning_wide_examples`)
    in each of the space's dtypes, launched once through ``ops.kernel`` and
    held against ``ops.interpret`` (the plain version) on a second copy of
    the same arguments; each wrapper's ``variant_launches`` must show every
    variant launched.  Returns {kernel: {variant: launches}}."""
    from repro_torch.kernels import registry
    from repro_torch.tuning.tune import _cast_args

    examples, wide = tuning_examples(), tuning_wide_examples(torch, np)
    launched = {}
    for name, wrapper in tuning_wrappers().items():
        ops = registry.get_kernel(name)
        space = ops.tuning_space
        wrapper.variant_launches.clear()
        cases, want_keys = [], set()
        problems = [("example", examples[name])]
        if name in wide:
            problems.append(("wide", wide[name]))
        for problem, args in problems:
            for dtype in space.dtypes:
                base = _cast_args(args, dtype)
                for raw in space.configs():
                    cfg = space.validate(raw, base)
                    if cfg is None:  # another route's variant
                        continue
                    # the example's short cache collapses every split
                    # onto one config: launch each as it was asked for
                    cfg = dict(raw) if name == "flash-decode" else cfg
                    kw = {**space.fixed, **cfg}
                    got_args, want_args = (
                        [a.to("cuda", copy=True)
                         if isinstance(a, torch.Tensor) else a
                         for a in base] for _ in range(2))
                    got = ops.kernel(*got_args, **kw)
                    want = ops.interpret(*want_args, **kw)
                    torch.cuda.synchronize()
                    err, ok = variant_close(torch, name, got, want)
                    want_keys.add(variant_key(name, cfg, got_args))
                    cases.append({"problem": problem, "dtype": dtype,
                                  "config": cfg, "max_abs_err": err,
                                  "ok": bool(ok)})
        launched[name] = dict(wrapper.variant_launches)
        report_cases("tuning", f"{name} variants", cases)
        missing = want_keys - set(launched[name])
        require(not missing, f"{name}: variants never launched: {missing}")
    return launched


def tuning_full_problems(torch, np):
    """(registry kernel, label, arguments on the card) of the full-size
    tunes, made from seeded generators, one at a time."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    kw = dict(device="cuda", generator=gen)
    x, y = (torch.randn((GEMM_N, GEMM_N), **kw) for _ in range(2))
    yield "gemm", f"{GEMM_N}^3 bf16", (x.bfloat16(), y.bfloat16())
    yield "gemm", f"{GEMM_N}^3 fp32", (x, y)
    del x, y
    (q, k, v, vl), _ = decode_problem(torch, np, ARCH_HEADS["qwen3-1.7b"],
                                      "ragged", 42)
    yield "flash-decode", (f"B{DENSE_B} S{DENSE_S} qwen3-1.7b heads, "
                           f"ragged, bf16"), (q, k, v, vl)
    del q, k, v, vl
    KV, G, D = ARCH_HEADS["qwen3-1.7b"]
    q_start = np.random.default_rng(6).integers(0, 449, size=PREFILL_B)
    args = prefill_inputs(torch, PREFILL_B, PREFILL_C, KV, G, D, KERNEL_BS,
                          PREFILL_NB, torch.bfloat16, q_start.tolist(),
                          [PREFILL_C] * PREFILL_B, seed=7)
    yield "flash-prefill", (f"serve qwen3-1.7b: B{PREFILL_B} C{PREFILL_C} "
                            f"nb{PREFILL_NB} bs{KERNEL_BS}, bf16"), \
        tuple(args[:7])
    del args
    a, b = (torch.randn(STREAM_SHAPE, **kw) for _ in range(2))
    yield "stream-triad", "2^21 x 128 fp32", (a, b, 3.0)
    del a, b
    yield "jacobi2d", f"{JACOBI_N}^2 fp32", (
        torch.randn((JACOBI_N, JACOBI_N), **kw),)
    re, im = (torch.randn((1 << RX_FULL_QUBITS,), **kw) for _ in range(2))
    yield "qc-gate", f"{RX_FULL_QUBITS} qubits, qubit 0, fp32", (re, im)


def check_full_size(torch, name, ops, args, configs):
    """Each of ``configs`` launched once through ``ops.kernel`` on copies of
    the full-size ``args`` and held against one ``ops.interpret`` call on
    the same inputs, with the tolerance of the kernel's own check, before
    anything is timed.  Returns {str(config): max abs err}."""
    space = ops.tuning_space

    def fresh():
        return [a.clone() if isinstance(a, torch.Tensor) else a
                for a in args]

    want = ops.interpret(*fresh(), **space.fixed)
    errs = {}
    for cfg in configs:
        got = ops.kernel(*fresh(), **space.fixed, **cfg)
        torch.cuda.synchronize()
        err, ok = variant_close(torch, name, got, want)
        require(ok, f"{name} {cfg} != plain at full size: {err}")
        errs[str(cfg)] = err
        del got
    del want
    return errs


def tuning_full_size(torch, np):
    """At each full-size problem: every candidate held against the plain
    version (:func:`check_full_size`), the tuner with every candidate timed
    (``keep`` = the candidate count, nothing persisted, nothing applied),
    and each candidate's device ms (median of CUDA events) beside the
    default's and its roofline prediction.  Returns one row a problem."""
    from repro_torch.core import hw
    from repro_torch.kernels import registry
    from repro_torch.tuning import prune, tune
    from repro_torch.tuning.space import canonical_dtype

    rows = []
    for name, label, args in tuning_full_problems(torch, np):
        ops = registry.get_kernel(name)
        space = ops.tuning_space
        dtype = canonical_dtype(args[0].dtype)
        survivors, _ = prune(space, args, hw.H100, dtype, keep=1 << 20)
        errs = check_full_size(torch, name, ops, args,
                               [cfg for cfg, _ in survivors])
        rec = tune(ops, args, chip=hw.H100, keep=len(survivors), store=None,
                   apply=False, repeats=3, device=None)
        variants = []
        for cfg, predicted in survivors:
            kw = {**space.fixed, **cfg}
            variants.append({
                "config": cfg, "predicted_ms": predicted * 1e3,
                "ms": device_ms(torch, lambda: ops.kernel(*args, **kw),
                                reps=20, warmup=3),
                "default": cfg == rec.default_config,
                "max_abs_err": errs[str(cfg)]})
        default_ms = next(v["ms"] for v in variants if v["default"])
        best = min(variants, key=lambda v: v["ms"])
        row = {"kernel": name, "problem": label, "dtype": dtype,
               "default_config": rec.default_config,
               "default_ms": default_ms, "best_config": best["config"],
               "best_ms": best["ms"], "tuned_config": rec.config,
               "tuned_best_ms": rec.best_time_s * 1e3,
               "tuned_default_ms": rec.default_time_s * 1e3,
               "timed": rec.timed, "variants": variants}
        emit({"phase": "tuning", "full_size": row})
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def tuning_entry(launches, rows, names, source, route=None, dtype=None):
    """The ``variants`` of a kernel's line in the last JSON: the source of
    its launch variants other than the default, each variant's launches in
    the tuning phase's check, and the full-size tunes of ``names``."""
    counts = {f"{name} {key}": n for name in names
              for key, n in launches[name].items()
              if route is None or key[0] == route}
    return {"source": source, "launches": counts,
            "full_size": [r for r in rows if r["kernel"] in names
                          and (dtype is None or r["dtype"] == dtype)]}


def phase_tuning(torch, np):
    """The roofline-guided autotuner on the card (see the module
    docstring's ``tuning``).  Leaves no tuned config installed."""
    import os
    import tempfile

    from repro_torch.analysis import analyze
    from repro_torch.core import hw
    from repro_torch.kernels import registry
    from repro_torch.perf.ledger import tuned_state_hash
    from repro_torch.tuning import load_tuned, tunable_kernels

    t0 = time.time()
    launched = check_tuning_variants(torch, np)
    check_s = time.time() - t0

    env_key = "REPRO_ARTIFACT_DIR"
    old_env = os.environ.get(env_key)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tuning-") as art:
        reports = []
        for _ in range(2):
            out = os.path.join(art, f"tuning{len(reports)}.json")
            proc = subprocess.run(
                [sys.executable, *TUNING_CLI, "--out", out],
                capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                env={**os.environ, "PYTHONPATH": str(SRC), env_key: art})
            require(proc.returncode == 0,
                    f"tuning CLI exited {proc.returncode}: "
                    f"{proc.stderr[-2000:]}")
            with open(out) as f:
                reports.append(json.load(f))
        first, second = reports
        n_cells = sum(len(registry.get_kernel(k).tuning_space.dtypes)
                      for k in tunable_kernels())
        require(len(first["records"]) == n_cells
                and not any(r["cached"] for r in first["records"])
                and first["stats"]["timing_runs"] > 0,
                f"first tuning CLI: {first['stats']}")
        require(len(second["records"]) == n_cells
                and all(r["cached"] for r in second["records"])
                and second["stats"]["timing_runs"] == 0,
                f"second tuning CLI: {second['stats']}")
        require([r["config"] for r in first["records"]]
                == [r["config"] for r in second["records"]],
                "the second CLI's configs differ from the first's")

        # in process: the CLI's records picked up without timing
        os.environ[env_key] = art
        try:
            records = {name: load_tuned(name, chip=hw.H100)
                       for name in tunable_kernels()}
            require(all(r is not None and r.cached
                        for r in records.values()),
                    f"load_tuned missed: {records}")
            outlook = analyze("kernel/gemm", hw.H100).tuning
            require(outlook["record"] == records["gemm"].config,
                    f"analyze's tuning record {outlook['record']} != the "
                    f"stored {records['gemm'].config}")
            tuned_hash = tuned_state_hash()
            require(tuned_hash != "", "tuned_state_hash() is empty")
            # .kernel resolves the installed config
            from repro_torch.kernels.gemm import kernel as gemm

            x, y = (a.cuda() for a in tuning_examples()["gemm"])
            gemm.gemm.variant_launches.clear()
            registry.GEMM.kernel(x, y)
            resolved = dict(gemm.gemm.variant_launches)
            want = variant_key("gemm", records["gemm"].config, (x, y))
            require(resolved == {want: 1},
                    f"GEMM.kernel launched {resolved}, not the tuned {want}")
        finally:
            for ops in registry.KERNELS.values():
                ops.clear_tuned()
            if old_env is None:
                os.environ.pop(env_key, None)
            else:
                os.environ[env_key] = old_env
        require(tuned_state_hash() == "", "a tuned config was left installed")

    t1 = time.time()
    full = tuning_full_size(torch, np)
    emit({"phase": "tuning", "variant_launches": {
              k: {str(key): n for key, n in v.items()}
              for k, v in launched.items()},
          "check_s": check_s,
          "cli": {"records": len(first["records"]),
                  "first": first["stats"], "second": second["stats"],
                  "configs": {f"{r['kernel']}/{r['dtype']}": r["config"]
                              for r in first["records"]}},
          "analyze_gemm_record": outlook["record"],
          "tuned_state_hash": tuned_hash, "gemm_kernel_resolved": str(want),
          "full_size_s": time.time() - t1,
          "seconds": time.time() - t0})
    return launched, full


# -- serving ------------------------------------------------------------------


#: the serve path's kernel wrappers, each with its launch count: the
#: paged kernels of the continuous scheduler and the contiguous decode
#: (2.3) of the wave scheduler's dense path
SERVE_KERNELS = ("flash_decode_paged", "flash_prefill_paged", "commit_paged",
                 "flash_decode")


def reset_counts(kernel) -> None:
    for name in SERVE_KERNELS:
        getattr(kernel, name).launches = 0
    kernel.flash_decode_paged.commit_launches = 0
    kernel.flash_prefill_paged.launches_by_width.clear()


def read_counts(kernel) -> dict:
    """The launches of :data:`SERVE_KERNELS`, and as ``decode_commits``
    the decode launches that committed their rows."""
    counts = {name: getattr(kernel, name).launches
              for name in SERVE_KERNELS}
    counts["decode_commits"] = kernel.flash_decode_paged.commit_launches
    return counts


def check_first_step(torch, engine, args) -> None:
    """Finite logits of the right shape from one step on a fresh cache: a
    decode step, and with chunked prefill a chunk step of full width; for
    a wave engine, a step of the dense decode."""
    from repro_torch.models import transformer

    cfg = engine.cfg
    B, nb = args.max_batch, args.max_len // args.block_size
    if args.scheduler == "wave":
        cache = transformer.init_cache(cfg, B, args.max_len, "cuda")
        logits, _ = transformer.decode_step(
            engine.params, cfg, torch.ones((B, 1), dtype=torch.int32,
                                           device="cuda"), cache)
        require(tuple(logits.shape) == (B, 1, cfg.vocab_padded)
                and bool(torch.isfinite(logits).all()),
                f"dense step logits {tuple(logits.shape)}, or non-finite")
        return
    cache = transformer.init_paged_cache(cfg, B, args.max_len,
                                         args.block_size, "cuda",
                                         kv_dtype=args.kv_dtype)
    bt = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                      device="cuda").reshape(B, nb)
    zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
    logits, _ = transformer.decode_step_paged(
        engine.params, cfg, torch.ones((B, 1), dtype=torch.int32,
                                       device="cuda"),
        cache, zeros, bt, block_size=args.block_size,
        kv_dtype=args.kv_dtype)
    checks = [logits]
    if args.prefill_chunk > 1:
        C = args.prefill_chunk
        lens = torch.full((B,), C, dtype=torch.int32, device="cuda")
        logits, _ = transformer.prefill_step_paged(
            engine.params, cfg, torch.ones((B, C), dtype=torch.int32,
                                           device="cuda"),
            cache, zeros + 1, bt, lens, block_size=args.block_size,
            kv_dtype=args.kv_dtype, last_rows=lens - 1)
        checks.append(logits)
    for logits in checks:
        require(tuple(logits.shape) == (B, 1, cfg.vocab_padded),
                f"logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), "non-finite logits")


def flash_layers(cfg) -> int:
    """The layers that run the flash kernels (2.1, 2.2) in a serve step:
    the grouped-query attention layers; an MLA model has none."""
    from repro_torch.models import transformer

    return 0 if cfg.mla is not None else transformer.count_layers(cfg,
                                                                  "attn")


def phase_serve(torch, argv, phase, params=None, cfg=None):
    """Serve the CLI's traffic on the card, on its seeded init or on the
    same weights ``params`` an earlier phase drew; with ``cfg`` (and its
    ``params``), on that config in place of the CLI's.  The launch counts
    are set to 0 just before the drain and read just after: every
    attention layer of every fused step runs exactly one of the attention
    kernels (a model without attention layers runs none), each kernel the
    path uses runs at least once, and every decode launch commits its rows
    in the same launch (the commit kernel alone runs only under a mesh).
    Only grouped-query attention layers run the kernels: an MLA model
    (latent pools, attended in torch ops) must launch none.  A wave engine
    (``--scheduler wave``) runs the contiguous decode (2.3) once a
    grouped-query layer a step, and none of the paged kernels.
    Returns (engine, counts, report)."""
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    args = serve_cli.parse_args(argv)
    t0 = time.time()
    if cfg is None:
        engine = serve_cli.make_engine(args, params=params)
    else:
        engine = ServeEngine(
            cfg, params, max_batch=args.max_batch, max_len=args.max_len,
            scheduler=args.scheduler,
            block_size=args.block_size, prefill_chunk=args.prefill_chunk,
            prefill_budget=args.prefill_budget, kv_dtype=args.kv_dtype,
            share_prefixes=args.share_prefixes, device=args.device)
    init_s = time.time() - t0
    cfg = engine.cfg
    check_first_step(torch, engine, args)
    engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel)
    report = serve_cli.serve(args, engine)
    torch.cuda.synchronize()
    counts = read_counts(kernel)
    stats = report["stats"]
    reqs = report["requests"]
    require(len(reqs) == args.requests and report["rejected"] == 0,
            f"{len(reqs)} of {args.requests} requests completed")
    require(all(r["new_tokens"] == args.max_new
                and all(0 <= t < cfg.vocab for t in r["tokens"])
                for r in reqs), "a request's tokens are short or invalid")
    steps = stats["fused_steps"]
    n_attn = flash_layers(cfg)
    attend = counts["flash_decode_paged"] + counts["flash_prefill_paged"]
    if args.scheduler == "wave":
        require(counts["flash_decode"] == n_attn * steps and attend == 0
                and counts["commit_paged"] == 0,
                f"{counts} kernel launches for {steps} wave steps of "
                f"{n_attn} grouped-query attention layers: one contiguous "
                f"decode a layer a step, no paged kernel")
        used = ["flash_decode"] if n_attn else []
    else:
        require(attend == n_attn * steps and counts["flash_decode"] == 0,
                f"{counts} kernel launches for {steps} fused steps of "
                f"{n_attn} grouped-query attention layers")
        require(counts["decode_commits"] == counts["flash_decode_paged"]
                and counts["commit_paged"] == 0,
                f"{counts}: every decode launch commits its rows, and the "
                f"commit kernel never runs alone")
        used = ["flash_decode_paged", "decode_commits"] if n_attn else []
        used += ["flash_prefill_paged"] if args.prefill_chunk > 1 \
            and n_attn else []
    require(all(counts[k] > 0 for k in used),
            f"a kernel of the path never launched: {counts}")
    emit({"phase": phase, "arch": cfg.name, "dtype": cfg.compute_dtype,
          "scheduler": args.scheduler, "layers": cfg.n_layers,
          "attention_layers": transformer.count_layers(cfg, "attn"),
          "flash_layers": n_attn,
          "prefill_chunk": args.prefill_chunk,
          "prefill_budget": args.prefill_budget, "kv_dtype": args.kv_dtype,
          "share_prefixes": args.share_prefixes,
          "logical_blocks": stats["logical_blocks"],
          "physical_blocks": stats["physical_blocks"],
          "shared_block_hits": stats["shared_block_hits"],
          "cow_copies": stats["cow_copies"],
          "block_dedup_ratio": stats["block_dedup_ratio"],
          "kv_bytes_stored": stats["kv_bytes_stored"],
          "requests": stats["requests"], "new_tokens": stats["new_tokens"],
          "prompt_tokens": sum(r["prompt_len"] for r in reqs),
          "fused_steps": steps, "launches": counts,
          "tok_s": stats["tok_s"], "wall_s": stats["wall_s"],
          "p50_latency_s": stats["p50_latency_s"],
          "p95_latency_s": stats["p95_latency_s"],
          "ttft_p50_s": stats["ttft_p50_s"],
          "ttft_p50_steps": stats["ttft_p50_steps"],
          "slot_utilization": stats["slot_utilization"],
          "init_s": init_s,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return engine, counts, report


def phase_serve_smoke(torch):
    """``python -m repro_torch.launch.serve`` with its defaults (gpt2-124m
    smoke, head dim 16, f32, ``--device cuda``), as its ``main`` runs it,
    and the same command with ``--device cpu``: the greedy streams must be
    equal, and on the card the decode kernel runs once per layer per fused
    step (counts set to 0 just before each drain, read just after)."""
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.launch import serve as serve_cli

    runs = {}
    for argv in ([], ["--device", "cpu"]):
        args = serve_cli.parse_args(argv)
        engine = serve_cli.make_engine(args)
        if args.warmup:
            engine.warmup()
        torch.cuda.synchronize()
        reset_counts(kernel)
        report = serve_cli.serve(args, engine)
        torch.cuda.synchronize()
        runs[args.device] = {
            "streams": [r["tokens"] for r in report["requests"]],
            "launches": read_counts(kernel),
            "fused_steps": report["stats"]["fused_steps"],
            "tok_s": report["stats"]["tok_s"]}
        layers, head_dim = engine.cfg.n_layers, engine.cfg.head_dim
    card, cpu = runs["cuda"], runs["cpu"]
    require(card["streams"] == cpu["streams"],
            f"default serve streams differ: card {card['streams']} cpu "
            f"{cpu['streams']}")
    require(card["launches"]["flash_decode_paged"]
            == layers * card["fused_steps"] > 0,
            f"{card['launches']} decode launches for "
            f"{card['fused_steps']} steps of {layers} layers")
    require(not any(cpu["launches"].values()),
            f"the CPU run launched kernels: {cpu['launches']}")
    emit({"phase": "serve-smoke", "argv": [], "head_dim": head_dim,
          "layers": layers, "streams_equal": True,
          "requests": len(card["streams"]),
          **{f"{dev}_{key}": run[key] for dev, run in runs.items()
             for key in ("launches", "fused_steps", "tok_s")}})


#: (group, a word of the kernel names in it) of the profile's device time:
#: the port's attention and commit kernels, then everything else (matmuls,
#: norms, elementwise ops, copies)
KERNEL_GROUPS = (("prefill_attention", "prefill_attend"),
                 ("decode_attention", "flash_decode_kernel"),
                 ("commit", "prefill_commit"))


def phase_profile(torch, np, engine, phase, prompt_lo, prompt_hi):
    """Where a serve step's time goes: a second, shorter drain of the same
    engine under ``torch.profiler`` (device activity only), giving the
    device's busy time by kernel (the top ten, and sums by
    :data:`KERNEL_GROUPS`) over the drain's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(1)
    first = engine.steps
    for uid in range(PROFILE_REQUESTS):
        prompt = rng.integers(0, engine.cfg.vocab,
                              size=int(rng.integers(prompt_lo,
                                                    prompt_hi + 1)))
        engine.submit(Request(uid=1000 + uid, prompt=prompt.astype(np.int32),
                              max_new_tokens=PROFILE_NEW))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    require(busy_ms > 0, "the profiler saw no device time")
    steps = engine.steps - first
    groups = {}
    for key, ms, _ in rows:
        group = next((g for g, word in KERNEL_GROUPS if word in key),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    emit({"phase": phase, "arch": engine.cfg.name, "fused_steps": steps,
          "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "step_ms": wall * 1e3 / steps,
          "kernels_per_step": sum(r[2] for r in rows) / steps,
          "device_ms_by_group": groups,
          "top": [{"kernel": k[:80], "device_ms": ms, "calls": n}
                  for k, ms, n in rows[:10]]})


# -- quantized and shared serving --------------------------------------------


def phase_serve_shared(torch, np, params):
    """The CLI at qwen3-1.7b's full width (bf16, 28 layers) with int8 KV
    pools, chunked prefill and a shared 256-token prefix, with prefix
    sharing and then, on the same weights, without: every request
    completes, the streams are equal, sharing stores strictly fewer
    physical blocks (dedup ratio > 1), and the int8 kernels launch (28
    decode or prefill calls a fused step, one commit a decode call).  Then
    two identical prompts drained with and without sharing: copy-on-write
    at the first generated token, equal streams.  Both runs serve
    ``params``, serve-chunked's draw of the same arch and seed (the CLI's
    own would draw the same weights again)."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    t0 = time.time()
    runs = {}
    for share in (True, False):
        argv = SHARED_ARGV + (["--share-prefixes"] if share else [])
        engine, counts, report = phase_serve(
            torch, argv, "serve-shared-int8" if share else
            "serve-unshared-int8", params)
        runs[share] = (engine.stats(), counts,
                       [r["tokens"] for r in report["requests"]])
        cfg = engine.cfg
        del engine
    (on, counts, streams), (off, _, streams_off) = runs[True], runs[False]
    require(streams == streams_off,
            "int8 streams differ with and without prefix sharing")
    require(on["physical_blocks"] < off["physical_blocks"]
            and on["block_dedup_ratio"] > 1.0
            and on["logical_blocks"] == off["logical_blocks"],
            f"sharing stored {on['physical_blocks']} of "
            f"{on['logical_blocks']} blocks, unshared "
            f"{off['physical_blocks']}")

    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=100).astype(np.int32)
    twins = {}
    for share in (True, False):
        engine = ServeEngine(cfg, params, max_batch=2, max_len=256,
                             block_size=16, prefill_chunk=64,
                             kv_dtype="int8", share_prefixes=share,
                             device="cuda")
        for uid in range(2):
            engine.submit(Request(uid=uid, prompt=prompt.copy(),
                                  max_new_tokens=8))
        done = engine.run_until_drained()
        twins[share] = ([done[u].generated for u in range(2)],
                        engine.stats())
    cow = twins[True][1]
    require(twins[True][0] == twins[False][0] and cow["cow_copies"] >= 1,
            f"identical prompts: streams equal "
            f"{twins[True][0] == twins[False][0]}, "
            f"{cow['cow_copies']} copy-on-write copies")
    bf16_bytes = transformer.paged_block_bytes(cfg, 16, "bf16")
    emit({"phase": "serve-shared-int8-summary", "arch": cfg.name,
          "streams_equal": True, "launches": counts,
          "physical_blocks": {"shared": on["physical_blocks"],
                              "unshared": off["physical_blocks"]},
          "logical_blocks": on["logical_blocks"],
          "block_dedup_ratio": on["block_dedup_ratio"],
          "shared_block_hits": on["shared_block_hits"],
          "kv_bytes_stored": on["kv_bytes_stored"],
          "kv_bytes_stored_bf16_pools": on["physical_blocks"] * bf16_bytes,
          "block_bytes": {"int8": transformer.paged_block_bytes(
              cfg, 16, "int8"), "bf16": bf16_bytes},
          "identical_prompts": {"cow_copies": cow["cow_copies"],
                                "shared_block_hits":
                                    cow["shared_block_hits"],
                                "streams_equal": True},
          "seconds": time.time() - t0})
    return counts


def phase_parity_int8(torch, np):
    """qwen3-1.7b at full width cut to 4 layers, float32: 14 teacher-forced
    tokens for 2 slots, token by token and as one chunk, on int8 pools on
    the card and on the CPU, and on f32 pools on the card.  The card's
    int8 logits must lie within ``PARITY_INT8_CARD_CPU`` of the CPU's and
    within the reference's qwen3 int8 budget (0.11) of its f32 cache's;
    the launch counts, set to 0 before the card's int8 run, must show one
    decode launch a layer and step, each committing its rows, and one
    prefill launch a layer, on int8 pools."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), n_layers=4,
                              param_dtype="float32",
                              compute_dtype="float32")
    T = 14
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, T))
    toks = torch.from_numpy(toks.astype(np.int32))
    got = {}
    weights = _cpu_and_card(transformer.init_lm(cfg, seed=0, device="cpu"))
    for dev in ("cuda", "cpu"):
        params = weights[dev]
        bt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4).to(dev)
        for kv_dtype in (("int8", "f32") if dev == "cuda" else ("int8",)):
            reset_counts(kernel)
            cache = transformer.init_paged_cache(cfg, 2, 64, 16, dev,
                                                 kv_dtype=kv_dtype)
            rows = []
            for t in range(T):
                out, cache = transformer.decode_step_paged(
                    params, cfg, toks[:, t:t + 1].to(dev), cache,
                    torch.full((2,), t, dtype=torch.int32).to(dev), bt,
                    block_size=16, kv_dtype=kv_dtype)
                rows.append(out[:, 0].cpu())
            pools = (cache["k"].dtype, "k_scale" in cache)
            cache = transformer.init_paged_cache(cfg, 2, 64, 16, dev,
                                                 kv_dtype=kv_dtype)
            chunk, _ = transformer.prefill_step_paged(
                params, cfg, toks.to(dev), cache,
                torch.zeros(2, dtype=torch.int32).to(dev), bt,
                torch.full((2,), T, dtype=torch.int32).to(dev),
                block_size=16, kv_dtype=kv_dtype)
            got[dev, kv_dtype] = (torch.stack(rows, 1), chunk.cpu())
            if (dev, kv_dtype) == ("cuda", "int8"):
                counts = read_counts(kernel)
                int8_pools = pools == (torch.int8, True)
        del params
    diff = {name: max((a - b).abs().max().item() for a, b in
                      zip(got[x], got[y]))
            for name, x, y in (("card_vs_cpu_int8", ("cuda", "int8"),
                                ("cpu", "int8")),
                               ("card_int8_vs_card_f32", ("cuda", "int8"),
                                ("cuda", "f32")))}
    token_vs_chunk = (got["cuda", "int8"][0]
                      - got["cuda", "int8"][1]).abs().max().item()
    L = cfg.n_layers
    want = {"flash_decode_paged": T * L, "flash_prefill_paged": L,
            "commit_paged": 0, "flash_decode": 0, "decode_commits": T * L}
    emit({"phase": "parity-int8", "arch": cfg.name, "layers": L,
          "dtype": "float32", "kv_dtype": "int8", "slots": 2, "tokens": T,
          "max_abs_diff": diff, "card_token_vs_chunk": token_vs_chunk,
          "limits": {"card_vs_cpu_int8": PARITY_INT8_CARD_CPU,
                     "card_int8_vs_card_f32": PARITY_INT8_BUDGET},
          "launches": counts, "int8_pools": int8_pools})
    require(int8_pools and counts == want,
            f"the card's int8 run: int8 pools with scales {int8_pools}, "
            f"launches {counts}, want {want}")
    require(diff["card_vs_cpu_int8"] <= PARITY_INT8_CARD_CPU,
            f"int8 logits on the card {diff['card_vs_cpu_int8']} from the "
            f"CPU's, over {PARITY_INT8_CARD_CPU}")
    require(diff["card_int8_vs_card_f32"] <= PARITY_INT8_BUDGET,
            f"int8 logits on the card {diff['card_int8_vs_card_f32']} from "
            f"its f32 cache's, over {PARITY_INT8_BUDGET}")


# -- parity -------------------------------------------------------------------


def _top2_gap(torch, cfg, params, tokens, block_size, kv_dtype="f32"):
    """Top-2 logit gap of the next token after ``tokens``, on the CPU, on
    pools of ``kv_dtype``."""
    from repro_torch.models import transformer

    max_len = -(-len(tokens) // block_size) * block_size
    cache = transformer.init_paged_cache(cfg, 1, max_len, block_size, "cpu",
                                         kv_dtype=kv_dtype)
    bt = torch.arange(1, 1 + max_len // block_size,
                      dtype=torch.int32)[None, :]
    for t, tok in enumerate(tokens):
        logits, cache = transformer.decode_step_paged(
            params, cfg, torch.tensor([[tok]], dtype=torch.int32), cache,
            torch.tensor([t], dtype=torch.int32), bt, block_size=block_size,
            kv_dtype=kv_dtype)
    top = logits[0, 0, :cfg.vocab].topk(2).values
    return float(top[0] - top[1])


def _cpu_and_card(params) -> dict:
    """The CPU's parameters and a copy on the card: the same numbers the
    seeded init gives on either device (it draws on the CPU), drawn
    once."""
    return {"cpu": params, "cuda": tree_to(params, "cuda")}


def _drain(cfg, params, prompts, device, **kw):
    from repro_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(cfg, params, device=device, **kw)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=p.copy(),
                              max_new_tokens=PARITY_NEW))
    done = engine.run_until_drained()
    return [done[u].generated for u in range(len(prompts))]


def _divergences(torch, cfg, cpu_params, prompts, ref, other, block_size,
                 kv_dtype="f32"):
    """Where ``other`` leaves ``ref``, the top-2 gap there (on pools of
    ``kv_dtype``), which must be under PARITY_TOP2_GAP (a near tie that
    fp32 rounding may flip)."""
    gaps = []
    for uid, (a, b) in enumerate(zip(ref, other)):
        if a == b:
            continue
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        tokens = list(prompts[uid]) + a[:i]
        gap = _top2_gap(torch, cfg, cpu_params, tokens, block_size,
                        kv_dtype)
        gaps.append({"uid": uid, "index": i, "top2_gap": gap})
        require(gap < PARITY_TOP2_GAP,
                f"request {uid} diverges at token {i} with top-2 gap {gap}")
    return gaps


def phase_parity(torch, np):
    import repro_torch.configs as configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config("gpt2-124m"),
                              param_dtype="float32",
                              compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 17)))
               .astype(np.int32) for _ in range(PARITY_REQUESTS)]
    params = _cpu_and_card(transformer.init_lm(cfg, seed=0, device="cpu"))
    kw = dict(max_batch=4, max_len=64, block_size=16)
    streams = {d: _drain(cfg, params[d], prompts, d, **kw)
               for d in ("cuda", "cpu")}
    gaps = _divergences(torch, cfg, params["cpu"], prompts, streams["cpu"],
                        streams["cuda"], 16)
    emit({"phase": "parity", "arch": cfg.name, "dtype": "float32",
          "requests": len(prompts), "new_tokens": PARITY_NEW,
          "streams_equal": streams["cuda"] == streams["cpu"],
          "divergences": gaps})


def phase_parity_chunked(torch, np):
    """qwen3-1.7b at full width cut to 4 layers, float32: chunked on the
    card (both kernels), chunked on the CPU (both plain versions) and
    token by token on the card must give the same greedy streams, up to
    near ties."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), n_layers=4,
                              param_dtype="float32",
                              compute_dtype="float32")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(20, 81)))
               .astype(np.int32) for _ in range(PARITY_REQUESTS)]
    params = _cpu_and_card(transformer.init_lm(cfg, seed=0, device="cpu"))
    kw = dict(max_batch=4, max_len=96, block_size=16)
    chunked = dict(kw, prefill_chunk=16, prefill_budget=32)
    reset_counts(kernel)
    streams = {"cuda_chunked": _drain(cfg, params["cuda"], prompts, "cuda",
                                      **chunked)}
    counts = read_counts(kernel)
    require(counts["flash_decode_paged"] > 0
            and counts["flash_prefill_paged"] > 0,
            f"the chunked parity run skipped a kernel: {counts}")
    streams["cpu_chunked"] = _drain(cfg, params["cpu"], prompts, "cpu",
                                    **chunked)
    streams["cuda_token"] = _drain(cfg, params["cuda"], prompts, "cuda",
                                   **kw)
    gaps = {name: _divergences(torch, cfg, params["cpu"], prompts,
                               streams["cpu_chunked"], streams[name], 16)
            for name in ("cuda_chunked", "cuda_token")}
    emit({"phase": "parity-chunked", "arch": cfg.name, "layers": 4,
          "dtype": "float32", "requests": len(prompts),
          "prompt_lens": [len(p) for p in prompts],
          "new_tokens": PARITY_NEW, "launches": counts,
          "streams_equal": {name: s == streams["cpu_chunked"]
                            for name, s in streams.items()},
          "divergences": gaps})


# -- the wave scheduler and the dense-cache path -------------------------------


#: the wave scheduler on the gpt2 serve traffic (16 requests, prompts
#: 4..64, 32 new tokens, 8 slots, max_len 256): two waves whose longest
#: prompts are 62 and 58 tokens, so (62 + 31) + (58 + 31) fused steps, the
#: same for qwen3-1.7b's vocab
WAVE_ARGV = SERVE_ARGV + ["--scheduler", "wave"]
WAVE_STEPS = 182
#: kernel 2.3 at the wave's shapes: 8 slots, every one at 96 of 256 rows
WAVE_B, WAVE_S, WAVE_LEN = 8, 256, 96


def _argv_for(argv, arch):
    return [arch if a == "gpt2-124m" else a for a in argv]


def phase_serve_wave(torch, np, params, continuous):
    """``WAVE_ARGV`` at full width in bf16 on the weights an earlier phase
    drew (``params``: arch -> weights), beside the continuous run of the
    same traffic on the same weights (``continuous``: arch -> its report,
    served here where missing).  Each wave run must serve 16 of 16 in
    ``WAVE_STEPS`` fused steps with exactly one launch of 2.3 a
    grouped-query layer a step and none of 2.1 or 2.2 (phase_serve's
    checks).  Streams are compared with the continuous run's: each
    request's first divergence must be a bf16 near tie
    (``runner.TIE_ULPS``).  Returns arch -> 2.3's launches."""
    from repro_torch.scenarios import runner

    launches = {}
    for arch, weights in params.items():
        if arch not in continuous:
            _, _, continuous[arch] = phase_serve(
                torch, _argv_for(SERVE_ARGV, arch), "serve-wave-continuous",
                weights)
        engine, counts, report = phase_serve(
            torch, _argv_for(WAVE_ARGV, arch), "serve-wave", weights)
        cfg = engine.cfg
        steps = report["stats"]["fused_steps"]
        require(steps == WAVE_STEPS,
                f"{arch}: {steps} wave steps, not {WAVE_STEPS}")
        require(counts["flash_decode"] == flash_layers(cfg) * WAVE_STEPS,
                f"{arch}: {counts}")
        cont = continuous[arch]
        want = [r["tokens"] for r in cont["requests"]]
        got = [r["tokens"] for r in report["requests"]]
        gaps = []
        for uid, (a, b) in enumerate(zip(want, got)):
            if a == b:
                continue
            i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            tokens = engine.completed[uid].prompt.tolist() + a[:i]
            gap, top_ulp = runner.top2_gap(cfg, engine.params, tokens,
                                           "cuda")
            gaps.append({"uid": uid, "index": i, "top2_gap": gap,
                         "top_ulp": top_ulp})
            require(gap <= runner.TIE_ULPS * top_ulp,
                    f"{arch} request {uid}: the wave leaves the continuous "
                    f"stream at token {i} with top-2 gap {gap}")
        emit({"phase": "serve-wave-vs-continuous", "arch": cfg.name,
              "dtype": cfg.compute_dtype, "wave_steps": steps,
              "continuous_steps": cont["stats"]["fused_steps"],
              "wave_tok_s": report["stats"]["tok_s"],
              "continuous_tok_s": cont["stats"]["tok_s"],
              "wave_over_continuous_tok_s": (report["stats"]["tok_s"]
                                             / cont["stats"]["tok_s"]),
              "mismatched_requests": len(gaps), "divergences": gaps,
              "flash_decode_launches": counts["flash_decode"]})
        launches[arch] = counts["flash_decode"]
        del engine
        torch.cuda.empty_cache()
    return launches


def _wave_drain(cfg, params, prompts, device, **kw):
    from repro_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(cfg, params, device=device, **kw)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=p.copy(),
                              max_new_tokens=PARITY_NEW))
    done = engine.run_until_drained()
    return [done[u].generated for u in range(len(prompts))], engine.steps


def _dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0))


def phase_parity_wave(torch, np):
    """The six serve archs' smoke configs in float32, the card against
    the CPU: the wave streams on the card must equal the CPU's wave
    streams and the card's continuous streams, up to near ties; 2.3 must
    launch once a grouped-query layer a wave step (never for mamba2-370m
    and deepseek-v2-lite-16b, whose layers have none); ``forward``,
    ``prefill`` and a ``decode_step`` loop on the card must equal the
    CPU's at the cell bound (rtol 1e-4, atol 1e-5), and the card's decode
    loop its own ``forward`` at the reference's 2e-3 (MoE capacity made
    dropless for that, as the reference's consistency test does)."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.models import transformer

    t0 = time.time()
    cell = dict(rtol=1e-4, atol=1e-5)
    for arch in configs.ALL_ARCHS:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        if cfg.is_encoder_decoder:  # the serve engine refuses it
            continue
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 17)))
                   .astype(np.int32) for _ in range(6)]
        cpu = transformer.init_lm(cfg, seed=0, device="cpu")
        card = tree_to(cpu, "cuda")
        kw = dict(max_batch=2, max_len=64, block_size=8)
        reset_counts(kernel)
        card_wave, steps = _wave_drain(cfg, card, prompts, "cuda",
                                       scheduler="wave", **kw)
        counts = read_counts(kernel)
        gqa = flash_layers(cfg)
        require(counts["flash_decode"] == gqa * steps
                and not any(counts[k] for k in SERVE_KERNELS
                            if k != "flash_decode"),
                f"{arch}: {counts} for {steps} wave steps of {gqa} "
                f"grouped-query layers")
        cpu_wave, cpu_steps = _wave_drain(cfg, cpu, prompts, "cpu",
                                          scheduler="wave", **kw)
        card_cont, cont_steps = _wave_drain(cfg, card, prompts, "cuda", **kw)
        require(steps == cpu_steps and cont_steps <= steps,
                f"{arch}: wave steps {steps} card, {cpu_steps} cpu, "
                f"continuous {cont_steps}")
        gaps = {name: _divergences(torch, cfg, cpu, prompts, cpu_wave, s, 8)
                for name, s in (("cuda_wave", card_wave),
                                ("cuda_continuous", card_cont))}
        # the dense entry points on the card against the CPU
        dcfg = _dropless(cfg)
        tok = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
        errs = {}
        full = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            t = torch.from_numpy(tok).to(dev)
            full[dev] = transformer.forward(p, dcfg, t)[0].cpu()
            last, cache = transformer.prefill(p, dcfg, t)
            full[dev + "_prefill"] = last.cpu()
            full[dev + "_cache"] = {k: v.cpu() for k, v in cache.items()
                                    if k != "pos"}
        reset_counts(kernel)
        cache = transformer.init_cache(dcfg, 2, 12, "cuda")
        dec = []
        for i in range(12):
            logits, cache = transformer.decode_step(
                card, dcfg, torch.from_numpy(tok[:, i:i + 1]).cuda(), cache)
            dec.append(logits[:, 0].cpu())
        dec = torch.stack(dec, 1)
        loop_launches = read_counts(kernel)["flash_decode"]
        require(loop_launches == gqa * 12,
                f"{arch}: {loop_launches} launches in a 12-step loop")
        for name, got, want, tol in (
                ("forward", full["cuda"], full["cpu"], cell),
                ("prefill", full["cuda_prefill"], full["cpu_prefill"], cell),
                ("decode_vs_forward", dec, full["cuda"],
                 dict(rtol=2e-3, atol=2e-3))):
            errs[name] = float((got - want).abs().max())
            require(torch.allclose(got, want, **tol),
                    f"{arch}: {name} max abs err {errs[name]}")
        for key, leaf in full["cuda_cache"].items():
            tol = (dict(rtol=2e-4, atol=2e-4) if key.endswith("_state")
                   else cell)
            errs["prefill_" + key] = float(
                (leaf.float() - full["cpu_cache"][key].float()).abs().max())
            require(torch.allclose(leaf, full["cpu_cache"][key], **tol),
                    f"{arch}: prefill cache {key}")
        emit({"phase": "parity-wave", "arch": cfg.name, "dtype": "float32",
              "layers": cfg.n_layers, "gqa_layers": gqa,
              "requests": len(prompts), "new_tokens": PARITY_NEW,
              "wave_steps": steps, "continuous_steps": cont_steps,
              "launches": counts, "decode_loop_launches": loop_launches,
              "streams_equal": {"cuda_wave": card_wave == cpu_wave,
                                "cuda_continuous": card_cont == cpu_wave},
              "divergences": gaps, "max_abs_err": errs,
              "seconds": time.time() - t0})
        del card


def wave_decode_timing(torch, np):
    """Kernel 2.3 at the wave's shapes (bf16, ``WAVE_B`` slots every one
    at ``WAVE_LEN`` of ``WAVE_S`` rows) for gpt2-124m's and qwen3-1.7b's
    heads: kernel, plain and library ms beside the least time for the
    live rows, and the host's us of one wrapper call.  The library
    yardstick is one SDPA call with a boolean length mask, as in
    :func:`flash_decode_timing`.  Returns arch -> row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref as fd_ref

    rows = {}
    for arch in ("gpt2-124m", "qwen3-1.7b"):
        KV, G, D = ARCH_HEADS[arch]
        gen = torch.Generator(device="cuda").manual_seed(71)
        kw = dict(device="cuda", generator=gen)
        q = torch.randn((WAVE_B, KV, G, D), **kw).to(torch.bfloat16)
        k, v = (torch.randn((WAVE_B, WAVE_S, KV, D), **kw)
                .to(torch.bfloat16) for _ in range(2))
        valid = np.full(WAVE_B, WAVE_LEN)
        vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
        args = (q, k, v, vl)

        def kernel():
            return fd.flash_decode(*args, block_s=WAVE_S)

        out = kernel()
        err, ok = decode_close(torch, out, fd.flash_decode_plain(
            *args, block_s=WAVE_S))
        require(ok, f"flash_decode != plain at the wave shape of {arch}: "
                    f"{err}")
        qh = q.reshape(WAVE_B, KV * G, 1, D)
        kh, vh = (x.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
                  for x in (k, v))
        mask = (torch.arange(WAVE_S, device="cuda")[None, :]
                < vl[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        lib_err = (library().reshape(out.shape).float()
                   - out.float()).abs().max().item()
        require(lib_err <= 2 * TOLERANCE["bfloat16"],
                f"SDPA yardstick disagrees at the wave shape: {lib_err}")
        bound_ms, bound_by = bound(fd_ref.decode_work_terms(q, k, valid),
                                   "bfloat16")
        row = {"max_abs_err": err,
               "ms": device_ms(torch, kernel, reps=50),
               "plain_ms": device_ms(torch, lambda: fd.flash_decode_plain(
                   *args, block_s=WAVE_S), reps=20),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": device_ms(torch, library, reps=50),
               "host_us": host_us(torch, kernel)}
        rows[arch] = row
        emit({"phase": "timing-wave", "kernel": "flash_decode",
              "arch_heads": arch, "B": WAVE_B, "S": WAVE_S, "KV": KV,
              "G": G, "D": D, "valid_len": WAVE_LEN, "dtype": "bfloat16",
              "tolerance": CLOSE_TOL, **row})
    return rows


# -- speculative decoding and sampled streams ----------------------------------


#: speculative decoding's serve traffic: the gpt2 serve traffic (16
#: requests, prompts 4..64, 32 new tokens, 8 slots, blocks of 16) token
#: by token with a gpt2-124m draft proposing ``SPEC_K`` tokens a slot
SPEC_K = 4
SPEC_ARGV = SERVE_ARGV + ["--draft", "gpt2-124m", "--spec-k", str(SPEC_K)]
#: the qwen3-1.7b target of serve-spec's first run (all 28 layers)
SPEC_QWEN_ARGV = ["qwen3-1.7b" if a == "gpt2-124m" and i == 1 else a
                  for i, a in enumerate(SPEC_ARGV)]
SAMPLED_ARGV = SERVE_ARGV + ["--temperature", "0.8", "--top-k", "50",
                             "--sample-seed", "7"]
#: the sampler check's logits: 8 slots, windows of 5, qwen3's vocab
SAMPLER_SHAPE = (8, 5, 151_936)
#: a token mismatch between the card's and the CPU's sampler is allowed
#: only where the top two of gumbel + scaled logits are this close
SAMPLER_GAP = 1e-5
#: parity-spec: the targets' depth and the gpt2 draft's
SPEC_PARITY_LAYERS = 4


def phase_serve_spec(torch, argv, phase, params, spec_rows):
    """Speculative serving through the CLI's path (``make_engine`` and
    ``serve``) on the card, the target's weights ``params`` drawn by an
    earlier phase and the draft's by its seeded init.  Counts are set to
    0 just before the drain and read just after: every target step is a
    verification (kernel 2.2 at ``SPEC_K + 1`` rows on each attention
    layer) or a decode step (kernel 2.1, committing), every draft step
    runs kernel 2.2 at one row on each of the draft's layers, and no other
    width runs.  Every request completes with valid tokens.  The line
    carries the device ms of kernel 2.2 at both widths, at the draft's and
    the target's heads, beside its bound (``spec_rows``, keyed by arch
    and width).  Returns the line."""
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.launch import serve as serve_cli

    args = serve_cli.parse_args(argv)
    t0 = time.time()
    engine = serve_cli.make_engine(args, params=params)
    init_s = time.time() - t0
    engine.warmup()
    torch.cuda.synchronize()
    reset_counts(kernel)
    report = serve_cli.serve(args, engine)
    torch.cuda.synchronize()
    counts = read_counts(kernel)
    widths = dict(kernel.flash_prefill_paged.launches_by_width)
    stats, reqs = report["stats"], report["requests"]
    cfg, dcfg = engine.cfg, engine._spec.cfg
    require(len(reqs) == args.requests and report["rejected"] == 0,
            f"{len(reqs)} of {args.requests} requests completed")
    require(all(r["new_tokens"] == args.max_new
                and all(0 <= t < cfg.vocab for t in r["tokens"])
                for r in reqs), "a request's tokens are short or invalid")
    n_attn, n_draft = flash_layers(cfg), flash_layers(dcfg)
    W = SPEC_K + 1
    verify = widths.get(W, 0) // n_attn
    decode = counts["flash_decode_paged"] // n_attn
    require(widths.get(W, 0) == n_attn * verify
            and counts["flash_decode_paged"] == n_attn * decode
            and verify + decode == stats["target_steps"]
            == stats["fused_steps"],
            f"{counts} {widths}: target steps {stats['target_steps']} of "
            f"{n_attn} attention layers")
    require(widths.get(1, 0) == n_draft * stats["draft_steps"] > 0,
            f"{widths}: {stats['draft_steps']} draft steps of {n_draft} "
            f"layers")
    require(set(widths) == {1, W} and verify > 0 and decode > 0,
            f"a width of the path never ran, or another did: {widths}")
    require(counts["decode_commits"] == counts["flash_decode_paged"]
            and counts["commit_paged"] == 0,
            f"{counts}: every decode launch commits its rows")
    line = {"phase": phase, "arch": cfg.name, "draft": dcfg.name,
            "layers": cfg.n_layers, "draft_layers": dcfg.n_layers,
            "dtype": cfg.compute_dtype, "spec_k": SPEC_K,
            "shared_vocab": engine._spec.shared_vocab, "vocab": cfg.vocab,
            "requests": stats["requests"], "new_tokens": stats["new_tokens"],
            "tok_s": stats["tok_s"], "wall_s": stats["wall_s"],
            "target_steps": stats["target_steps"],
            "verify_steps": verify, "decode_steps": decode,
            "draft_steps": stats["draft_steps"],
            "drafted_tokens": stats["drafted_tokens"],
            "accepted_tokens": stats["accepted_tokens"],
            "acceptance_rate": stats["acceptance_rate"],
            "launches": counts, "prefill_launches_by_width": widths,
            "launches_a_step": {
                "prefill_w1_per_draft_step":
                    widths.get(1, 0) / stats["draft_steps"],
                f"prefill_w{W}_per_target_step":
                    widths.get(W, 0) / stats["target_steps"],
                "decode_per_target_step":
                    counts["flash_decode_paged"] / stats["target_steps"]},
            "kernel_2_2": {
                f"width {C} ({name})": {
                    key: spec_rows[name, C][key]
                    for key in ("ms", "bound_ms", "bound_by", "plain_ms")}
                for C, name in ((1, dcfg.name), (W, cfg.name))},
            "p50_latency_s": stats["p50_latency_s"],
            "ttft_p50_s": stats["ttft_p50_s"], "init_s": init_s}
    emit(line)
    return line


def phase_serve_sampled(torch, np, params, greedy):
    """gpt2-124m at full width sampled (T 0.8, top-k 50, seed 7) through
    the CLI's path, twice on the same weights: both runs give the same
    streams, and they differ from the greedy ``greedy`` streams of the
    same traffic.  Then the sampler on the card against the same sampler
    on the CPU over ``SAMPLER_SHAPE`` random logits: the threefry keys and
    the uniforms bit-equal, and the tokens equal except where the top two
    of gumbel + scaled logits lie within ``SAMPLER_GAP``."""
    from repro_torch.serve import threefry
    from repro_torch.serve.sampling import SlotSampler

    runs = [phase_serve(torch, SAMPLED_ARGV, f"serve-sampled-run{i}",
                        params=params)[2] for i in (1, 2)]
    streams = [[r["tokens"] for r in rep["requests"]] for rep in runs]
    require(streams[0] == streams[1], "two sampled runs differ")
    require(streams[0] != greedy, "the sampled streams are the greedy ones")
    same_as_greedy = sum(a == b for a, b in zip(streams[0], greedy))

    B, W, V = SAMPLER_SHAPE
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((B, W, V), generator=gen) * 2.0
    reqs = [dataclasses.make_dataclass("R", ["uid", "generated"])(
        uid, [0] * g) for uid, g in zip(
            (0, 1, 7, 2**31 - 1, 2**32 - 1, 12, 99, 1000),
            (0, 3, 17, 1, 31, 5, 0, 2))]
    sampler = SlotSampler(V, temperature=0.8, top_k=50, seed=7)
    toks = {dev: sampler.select(logits.to(dev), reqs, offset=1).cpu()
            for dev in ("cuda", "cpu")}
    flat_u = torch.tensor([r.uid for r in reqs for _ in range(W)])
    flat_i = torch.tensor([len(r.generated) + 1 + i for r in reqs
                           for i in range(W)])
    keys, unis, gums = {}, {}, {}
    for dev in ("cuda", "cpu"):
        key = threefry.fold_in(threefry.fold_in(
            threefry.prng_key(7, dev), flat_u.to(dev)), flat_i.to(dev))
        keys[dev] = torch.stack(key).cpu()
        unis[dev] = threefry.uniform(key, V, threefry._TINY, 1.0).cpu()
        gums[dev] = threefry.gumbel(key, V).cpu()
    require(torch.equal(keys["cuda"], keys["cpu"]), "keys differ")
    require(torch.equal(unis["cuda"].view(torch.int32),
                        unis["cpu"].view(torch.int32)),
            "uniforms differ in their bits")
    scaled = logits.reshape(B * W, V) * sampler._inv_t
    kth = scaled.topk(50, dim=-1).values[..., -1:]
    scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    top2 = (gums["cpu"] + scaled).topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).reshape(B, W)
    mismatch = toks["cuda"] != toks["cpu"]
    require(not bool((mismatch & (gap >= SAMPLER_GAP)).any()),
            f"card and CPU samplers differ outside near ties: "
            f"{mismatch.sum().item()} tokens")
    emit({"phase": "serve-sampled", "argv": SAMPLED_ARGV[-6:],
          "streams_equal_across_runs": True,
          "requests_equal_to_greedy": same_as_greedy,
          "tok_s": [rep["stats"]["tok_s"] for rep in runs],
          "sampler_shape": list(SAMPLER_SHAPE), "keys_equal": True,
          "uniforms_bit_equal": True,
          "gumbel_max_abs_diff": (gums["cuda"] - gums["cpu"]).abs().max()
          .item(),
          "token_mismatches": int(mismatch.sum()),
          "smallest_gap": gap.min().item()})


def _sampled_gap(torch, cfg, params, tokens, block_size, sampler, uid,
                 index):
    """The top-2 gap of gumbel + scaled logits of ``sampler``'s draw for
    (``uid``, generation ``index``) after ``tokens``, on the CPU."""
    from repro_torch.models import transformer
    from repro_torch.serve import threefry

    max_len = -(-len(tokens) // block_size) * block_size
    cache = transformer.init_paged_cache(cfg, 1, max_len, block_size, "cpu")
    bt = torch.arange(1, 1 + max_len // block_size,
                      dtype=torch.int32)[None, :]
    for t, tok in enumerate(tokens):
        logits, cache = transformer.decode_step_paged(
            params, cfg, torch.tensor([[tok]], dtype=torch.int32), cache,
            torch.tensor([t], dtype=torch.int32), bt, block_size=block_size)
    scaled = logits[0, 0, :sampler.vocab] * sampler._inv_t
    if sampler.top_k:
        kth = scaled.topk(sampler.top_k).values[-1]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(sampler.seed),
                                            torch.tensor(uid)),
                           torch.tensor(index))
    top = (threefry.gumbel(key, sampler.vocab) + scaled).topk(2).values
    return float(top[0] - top[1])


def _spec_drain(cfg, params, dcfg, dparams, prompts, device, **kw):
    """Streams and counts of the port's engine on ``prompts``: speculative
    with the draft (``dcfg``, ``dparams``) when it is given."""
    from repro_torch.serve.engine import Request, ServeEngine

    if dcfg is not None:
        kw.update(spec_k=SPEC_K, draft_cfg=dcfg, draft_params=dparams)
    engine = ServeEngine(cfg, params, device=device, **kw)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=p.copy(),
                              max_new_tokens=PARITY_NEW))
    done = engine.run_until_drained()
    stats = engine.stats()
    return ([done[u].generated for u in range(len(prompts))],
            {k: stats[k] for k in ("fused_steps", "draft_steps",
                                   "drafted_tokens", "accepted_tokens")})


def phase_parity_spec(torch, np):
    """Speculative decoding on the card against the CPU, float32: targets
    qwen3-1.7b and mamba2-370m at full width cut to ``SPEC_PARITY_LAYERS``
    layers, with a gpt2-124m draft at full width cut to as many layers
    (another model, so most proposals are rejected, and mamba2 restores
    and replays).  For each target, greedy and sampled (T 0.8, top-k 50):
    the card's speculative streams against the CPU port's speculative
    streams and the card's own non-speculative streams, divergences only
    at near ties (greedy: the top-2 logit gap under ``PARITY_TOP2_GAP``;
    sampled: the top-2 gap of gumbel + scaled logits, likewise); drafted
    and accepted counts equal on card and CPU where the streams are.
    The sampled run is mamba2's (one is enough, and its CPU run is the
    cheaper)."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.models import transformer
    from repro_torch.serve.sampling import SlotSampler

    f32 = dict(param_dtype="float32", compute_dtype="float32",
               n_layers=SPEC_PARITY_LAYERS)
    dcfg = dataclasses.replace(configs.get_config("gpt2-124m"), **f32)
    dparams = _cpu_and_card(transformer.init_lm(dcfg, seed=1, device="cpu"))
    out = {}
    for arch in ("qwen3-1.7b", "mamba2-370m"):
        cfg = dataclasses.replace(configs.get_config(arch), **f32)
        params = _cpu_and_card(transformer.init_lm(cfg, seed=0,
                                                   device="cpu"))
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, dcfg.vocab, size=int(rng.integers(4, 33)))
                   .astype(np.int32) for _ in range(PARITY_REQUESTS)]
        modes = [("greedy", {})]
        if arch == "mamba2-370m":  # the restore-and-replay path, sampled
            modes.append(("sampled", dict(temperature=0.8, top_k=50,
                                          sample_seed=7)))
        for mode, samp in modes:
            t0 = time.time()
            kw = dict(max_batch=4, max_len=64, block_size=16, **samp)
            reset_counts(kernel)
            card, card_counts = _spec_drain(cfg, params["cuda"], dcfg,
                                            dparams["cuda"], prompts, "cuda",
                                            **kw)
            launches = read_counts(kernel)
            widths = dict(kernel.flash_prefill_paged.launches_by_width)
            require(widths.get(1, 0) > 0 and (
                not transformer.count_layers(cfg, "attn")
                or widths.get(SPEC_K + 1, 0) > 0),
                f"parity-spec {arch} skipped a width: {widths}")
            cpu, cpu_counts = _spec_drain(cfg, params["cpu"], dcfg,
                                          dparams["cpu"], prompts, "cpu",
                                          **kw)
            plain, _ = _spec_drain(cfg, params["cuda"], None, None, prompts,
                                   "cuda", **kw)
            if samp:
                sampler = SlotSampler(cfg.vocab, **{
                    "seed" if k == "sample_seed" else k: v
                    for k, v in samp.items()})
                gaps = {}
                for name, got in (("cuda_spec", card),
                                  ("cuda_plain", plain)):
                    gaps[name] = []
                    for uid, (a, b) in enumerate(zip(cpu, got)):
                        if a == b:
                            continue
                        i = next((i for i, (x, y) in enumerate(zip(a, b))
                                  if x != y), min(len(a), len(b)))
                        gap = _sampled_gap(torch, cfg, params["cpu"],
                                           list(prompts[uid]) + a[:i], 16,
                                           sampler, uid, i)
                        gaps[name].append({"uid": uid, "index": i,
                                           "top2_gap": gap})
                        require(gap < PARITY_TOP2_GAP,
                                f"{arch} sampled: request {uid} diverges at "
                                f"token {i} with gap {gap}")
            else:
                gaps = {name: _divergences(torch, cfg, params["cpu"],
                                           prompts, cpu, got, 16)
                        for name, got in (("cuda_spec", card),
                                          ("cuda_plain", plain))}
            if card == cpu:
                require(card_counts == cpu_counts,
                        f"{arch} {mode}: card counts {card_counts} != "
                        f"CPU {cpu_counts}")
            out[f"{arch} {mode}"] = {
                "streams_equal": {"cuda_spec": card == cpu,
                                  "cuda_plain": plain == cpu},
                "card": card_counts, "cpu": cpu_counts,
                "launches": launches, "prefill_launches_by_width": widths,
                "divergences": gaps, "seconds": time.time() - t0}
        del params
    emit({"phase": "parity-spec", "dtype": "float32",
          "layers": SPEC_PARITY_LAYERS, "draft": dcfg.name,
          "spec_k": SPEC_K, "requests": PARITY_REQUESTS,
          "new_tokens": PARITY_NEW, "runs": out})


# -- the scenario matrix ------------------------------------------------------


#: the scenario phase's gpt2-124m matrix, sized like the serve phases:
#: both schedulers and every fault plan (preempt has no slots to steal
#: under the wave), so 7 cells
SCENARIO_SIZING = dict(requests=16, max_new=32, max_batch=8, max_len=256,
                       block_size=16)
#: its qwen3-1.7b cell: chunked by 64 under a budget of 256, preempted,
#: held to its fault twin and its token-by-token chunk twin
SCENARIO_QWEN = dict(requests=8, max_new=16, max_batch=8, max_len=512,
                     block_size=16, prefill_chunks=[64], prefill_budget=256,
                     faults=["preempt"], schedulers=["continuous"])
#: the injected uids a malformed cell must reject
MALFORMED_UIDS = {100_000, 100_001}


def _scenario_spec(arch, lo, hi, **over):
    from repro_torch.scenarios import (ArrivalSpec, EosSpec, MatrixSpec,
                                       PromptSpec)

    kw = dict(arrivals=[ArrivalSpec(kind="poisson", rate=0.5)],
              prompts=[PromptSpec(kind="uniform", lo=lo, hi=hi)],
              eos=[EosSpec(p_early=0.1)], archs=[arch],
              schedulers=["continuous", "wave"],
              faults=["none", "preempt", "device-loss", "malformed"])
    kw.update(over)
    return MatrixSpec(**kw)


def phase_scenario(torch, np, params):
    """The port's scenario runner at full width on the card, twins
    included (``run_cell``), on the weights earlier phases drew
    (``params``: arch -> (cfg, weights), bf16): gpt2-124m under both
    schedulers and every fault plan (7 cells), and one qwen3-1.7b cell,
    chunked by 64 and preempted.  Every cell meets its default SLOs with
    no error; preempt cells preempt, device-loss cells restart, malformed
    cells reject the two injected uids.  The gpt2 cells' streams equal
    their twins' exactly (8-row steps, the same launches); the qwen3
    cell's equal its fault twin's and its token-by-token chunk twin's up
    to near ties (its chunk step and the token step round differently).
    Launches are counted a cell, twins included: 2.1 in the continuous
    cells, 2.3 in the wave cells, 2.2 in the qwen3 cell.  Returns the
    launches over the phase and the cells' results."""
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.scenarios import runner

    t_phase = time.time()
    dev = str(torch.device("cuda", torch.cuda.current_device()))
    cells = (_scenario_spec("gpt2-124m", 4, 64, **SCENARIO_SIZING).cells()
             + _scenario_spec("qwen3-1.7b", 64, 256,
                              **SCENARIO_QWEN).cells())
    require(len(cells) == 8, f"{len(cells)} scenario cells, not 8")
    for arch, entry in params.items():
        runner._PARAMS[(arch, dev)] = entry
    total = {}
    rows = []
    results = []
    try:
        for cell in cells:
            t0 = time.time()
            torch.cuda.synchronize()
            reset_counts(kernel)
            r = runner.run_cell(cell, device="cuda")
            torch.cuda.synchronize()
            counts = read_counts(kernel)
            seconds = time.time() - t0
            results.append(r)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            require(not r.error, f"{cell.cell_id}: {r.error}")
            require(not r.slo_failures,
                    f"{cell.cell_id}: SLOs {r.slo_failures}")
            require(r.stats["requests"] == cell.requests,
                    f"{cell.cell_id}: {r.stats['requests']} of "
                    f"{cell.requests} requests served")
            if cell.fault == "preempt":
                require(r.stats["preemptions"] >= 1,
                        f"{cell.cell_id}: no preemption")
            if cell.fault == "device-loss":
                require(r.restarts >= 1, f"{cell.cell_id}: no restart")
            if cell.fault == "malformed":
                require({u for u, _ in r.rejected} == MALFORMED_UIDS,
                        f"{cell.cell_id}: rejected {r.rejected}")
            if cell.scheduler == "wave":
                require(counts["flash_decode"] > 0
                        and counts["flash_decode_paged"] == 0,
                        f"{cell.cell_id}: {counts}")
            else:
                require(counts["flash_decode_paged"] > 0
                        and counts["flash_decode"] == 0,
                        f"{cell.cell_id}: {counts}")
            if cell.prefill_chunk > 1:
                require(counts["flash_prefill_paged"] > 0,
                        f"{cell.cell_id}: {counts}")
            # the runner's own verdict: a twin's divergence at a bf16 near
            # tie is in r.ties (runner.judge_ties), any other one a diff
            ties = r.ties
            require(r.golden_ok, f"{cell.cell_id}: twins differ: "
                    f"{r.golden_diffs}")
            if cell.arch == "gpt2-124m":
                require(r.golden_checked == (cell.fault != "none")
                        and not ties,
                        f"{cell.cell_id}: twins tie at {ties}")
            else:
                require(r.golden_checked, f"{cell.cell_id}: no twin")
            rows.append({"cell": cell.cell_id, "tok_s": r.stats["tok_s"],
                         "fused_steps": r.stats["fused_steps"],
                         "new_tokens": r.stats["new_tokens"],
                         "preemptions": r.stats["preemptions"],
                         "restarts": r.restarts,
                         "rejected": [u for u, _ in r.rejected],
                         "twin": "equal" if r.golden_ok else "near ties",
                         "ties": ties,
                         "ttft_p95_steps": r.stats["ttft_p95_steps"],
                         "launches": counts, "seconds": seconds})
    finally:
        for arch in params:
            runner._PARAMS.pop((arch, dev), None)
    emit({"phase": "scenario", "cells": rows, "launches": total,
          "seconds": time.time() - t_phase})
    return total, results


def phase_parity_scenario(torch, np):
    """The smoke matrix's gpt2-124m cells and its qwen3-1.7b cells (both
    schedulers, every fault plan: 7 an arch) through ``run_cell`` on the
    card and on the CPU with the same f32 smoke weights: every cell ok on
    both, twins included, and the card's streams the CPU's up to near
    ties (``_divergences``)."""
    import repro_torch.configs as configs
    from repro_torch.models import transformer
    from repro_torch.scenarios import runner, sample_trace, smoke_matrix

    t0 = time.time()
    dev = str(torch.device("cuda", torch.cuda.current_device()))
    rows = []
    for arch in PARITY_SCENARIO_ARCHS:
        cfg = configs.get_smoke_config(arch)
        cpu = transformer.init_lm(cfg, seed=0, device="cpu")
        keys = {"cpu": (arch, "cpu"), "cuda": (arch, dev)}
        runner._PARAMS[keys["cpu"]] = (cfg, cpu)
        runner._PARAMS[keys["cuda"]] = (cfg, tree_to(cpu, "cuda"))
        cells = [c for c in smoke_matrix().cells() if c.arch == arch]
        require(len(cells) == 7, f"{len(cells)} {arch} smoke cells, not 7")
        try:
            for cell in cells:
                res = {}
                for d in ("cuda", "cpu"):
                    r = runner.run_cell(cell, device=d)
                    require(r.ok, f"{cell.cell_id} on {d}: {r.error} "
                            f"{r.golden_diffs} {r.slo_failures}")
                    res[d] = r
                uids = sorted(res["cpu"].tokens)
                require(sorted(res["cuda"].tokens) == uids,
                        f"{cell.cell_id}: served uids differ")
                prompts = {s.uid: s.prompt
                           for s in sample_trace(cell, cfg.vocab)}
                gaps = _divergences(torch, cfg, cpu,
                                    [prompts[u] for u in uids],
                                    [res["cpu"].tokens[u] for u in uids],
                                    [res["cuda"].tokens[u] for u in uids],
                                    cell.block_size)
                rows.append({"cell": cell.cell_id,
                             "streams_equal": (res["cuda"].tokens
                                               == res["cpu"].tokens),
                             "divergences": gaps,
                             "fused_steps": {d: r.stats["fused_steps"]
                                             for d, r in res.items()},
                             "restarts": res["cuda"].restarts,
                             "preemptions":
                                 res["cuda"].stats["preemptions"]})
        finally:
            for key in keys.values():
                runner._PARAMS.pop(key, None)
    emit({"phase": "parity-scenario", "archs": list(PARITY_SCENARIO_ARCHS),
          "dtype": "float32", "cells": rows, "seconds": time.time() - t0})


# -- the perf ledger ------------------------------------------------------------


#: the default serve command's ledger key, and the stats of its row that
#: are exact (no wall clock): equal on the card and on the CPU
LEDGER_SERVE_KEY = "serve/gpt2-124m@continuous"
LEDGER_EXACT = ("fused_steps", "busy_slot_steps", "slot_steps", "new_tokens",
                "ttft_p50_steps", "ttft_p95_steps")


def phase_perf_ledger(torch, card, scenario_results, analysis_report,
                      analysis_cells):
    """The perf ledger in a fresh artifact directory (``$REPRO_ARTIFACT_DIR``
    set for the phase, restored after).  The default serve command with
    ``--record`` twice on the card and once with ``--device cpu``: two
    runs in series h100/fp32, one in grace-core/fp32, their
    :data:`LEDGER_EXACT` counters equal, the card's ``env.gpu`` the
    ``nvidia-smi`` line ``card``, kernel 2.1 once a layer a step (the
    warm-up's step included; counts set to 0 before each command, read
    after).  ``python -m repro_torch.perf gate`` (its ``main``) on the
    second card run resolves the first as its baseline and regresses no
    counter of the triage's; its exit code and its tok/s and latency
    deltas are printed, not judged (the serve tok/s moves by up to 40%
    between runs).  The scenario phase's cells recorded through
    ``record_cell`` twice: each second record gates clean against its
    first.  The analysis phase's service report recorded through the
    service CLI's ``--record`` path (chip the first swept, h100; dtype
    "mixed": fp32 and bf16 cells), its ``run_id`` and ``trajectory``
    stamped, then every ``@h100`` row re-triaged: its Fig. 8 class that of
    the report.  The trajectory exports one ``BENCH_<seq>.json`` a run into
    the temporary directory."""
    import os
    import tempfile

    import repro_torch.configs as configs
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.launch import serve as serve_cli
    from repro_torch.perf import (capture_env, default_ledger,
                                  export_trajectory, gate_run, triage)
    from repro_torch.perf.__main__ import main as perf_main
    from repro_torch.scenarios import runner
    from repro_torch.serve import analysis_service as service_cli

    t0 = time.time()
    layers = configs.get_smoke_config("gpt2-124m").n_layers
    saved = os.environ.get("REPRO_ARTIFACT_DIR")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ledger-") as tmp:
        os.environ["REPRO_ARTIFACT_DIR"] = tmp
        try:
            launches = []
            for argv in ([], [], ["--device", "cpu"]):
                torch.cuda.synchronize()
                reset_counts(kernel)
                require(serve_cli.main(argv + ["--record"]) == 0,
                        f"serve {argv} --record")
                torch.cuda.synchronize()
                launches.append(read_counts(kernel))
            ledger = default_ledger()
            runs = ledger.runs()
            require(ledger.root == os.path.join(tmp, "torch", "perf"),
                    f"ledger at {ledger.root}")
            require([r.env.series_key() for r in runs]
                    == ["h100/fp32", "h100/fp32", "grace-core/fp32"]
                    and all(list(r.metrics) == [LEDGER_SERVE_KEY]
                            for r in runs),
                    f"serve runs {[(r.env.series_key(), list(r.metrics)) for r in runs]}")
            rows = [r.metrics[LEDGER_SERVE_KEY] for r in runs]
            exact = [{n: row[n] for n in LEDGER_EXACT} for row in rows]
            require(exact[0] == exact[1] == exact[2],
                    f"exact counters differ: {exact}")
            require(runs[0].env.gpu == runs[1].env.gpu == card
                    and runs[2].env.gpu == card,
                    f"env.gpu {runs[0].env.gpu!r}, nvidia-smi {card!r}")
            steps = exact[0]["fused_steps"]
            for n, want in zip(launches, (layers * (steps + 1),) * 2
                               + (0,)):
                require(n["flash_decode_paged"] == want
                        and (want > 0 or not any(n.values())),
                        f"launches {n} for {steps} steps of {layers} "
                        f"layers and the warm-up's step")
            gate_out = os.path.join(tmp, "gate.json")
            rc = perf_main(["gate", "--run", runs[1].run_id,
                            "--out", gate_out])
            with open(gate_out) as f:
                gate = json.load(f)
            require(gate["baseline_id"] == runs[0].run_id,
                    f"gate baseline {gate['baseline_id']}")
            counter_regressions = [
                r for r in gate["comparison"]["regressions"]
                if r["metric"] in triage._COUNTER_METRICS]
            require(not counter_regressions,
                    f"counters regressed: {counter_regressions}")
            deltas = {d["metric"]: d["rel_delta"]
                      for d in gate["comparison"]["deltas"]
                      if d["metric"] in ("tok_s", "p50_latency_s",
                                         "p95_latency_s", "ttft_p50_s",
                                         "ttft_p95_s")}

            env = capture_env(chip="h100")
            first = [runner.record_cell(r, env=env)
                     for r in scenario_results]
            require(len({k for r in first for k in r.metrics}) == 8,
                    f"{len(first)} scenario rows")
            for r, before in zip(scenario_results, first):
                again = runner.record_cell(r, env=env)
                g = gate_run(again, ledger)
                require(g.ok and g.baseline_id == before.run_id,
                        f"{r.cell.cell_id}: re-recorded gate {g.describe()}")

            # the service's own --record path, on an idle service that
            # resolves the same ledger (its drained one held the full-size
            # problems on the card)
            report = dict(analysis_report)
            arun = service_cli.record(service_cli.AnalysisService(),
                                      report, ("h100", "grace-core"))
            require(arun.env.chip == "h100"
                    and report["run_id"] == arun.run_id
                    and report["trajectory"]["runs"] == 3 + 16 + 1,
                    f"analysis run {arun.env.series_key()} "
                    f"{report['trajectory']}")
            printed = {f"{c['workload']}@{c['chip']}/{c['dtype']}":
                       c["class"] for c in analysis_cells}
            require(set(arun.metrics) == set(printed),
                    f"analysis rows {sorted(arun.metrics)}")
            classes = {}
            for key in sorted(arun.metrics):
                t = triage._triage_one(key, [], arun, arun, {})
                classes[key] = int(t.class_after)
            h100 = [k for k in classes if "@h100/" in k]
            require(h100 and all(classes[k] == printed[k] for k in h100),
                    f"re-triaged classes {classes} against {printed}")
            exported = export_trajectory(ledger, os.path.join(tmp, "bench"))
            require(len(exported) == len(ledger.runs()) == 3 + 16 + 1,
                    f"{len(exported)} trajectory points")
        finally:
            if saved is None:
                os.environ.pop("REPRO_ARTIFACT_DIR", None)
            else:
                os.environ["REPRO_ARTIFACT_DIR"] = saved
    emit({"phase": "perf-ledger", "serve_runs": [
              {"run_id": r.run_id, "series": r.env.series_key(),
               "gpu": r.env.gpu, "tok_s": row["tok_s"], **e}
              for r, row, e in zip(runs, rows, exact)],
          "launches": launches, "gate_exit_code": rc,
          "gate_deltas": deltas,
          "gate_regressions": [r["metric"] for r in
                               gate["comparison"]["regressions"]],
          "scenario_rows": len(first),
          "analysis_rows": len(arun.metrics),
          "analysis_series": arun.env.series_key(),
          "h100_classes": {k: classes[k] for k in h100},
          "classes_equal_off_h100": sum(classes[k] == printed[k]
                                        for k in classes if k not in h100),
          "seconds": time.time() - t0})


# -- mixture of experts, SSM and hybrid ------------------------------------


#: (group, module, its layer functions, its other functions) of the
#: grouped profiles' split of the device time: the group counts the
#: launches of all of them, and one of its layer functions runs once a
#: layer of the group's kind in every step (the mixers' decode steps call
#: ``mamba_decode``, their chunk steps ``mamba_chunk``)
MOE_GROUPS = (("expert_products", "moe", ("_expert_gemms",), ()),
              ("route_dispatch_combine", "moe", ("_route",),
               ("_dispatch", "_combine")),
              ("shared_expert", "moe", ("_shared_experts",), ()))
MAMBA_GROUPS = (("mamba_mixers", "ssm", ("mamba_decode", "mamba_chunk"),
                 ()),)
#: an MLA layer's attention (projections, latent gather and commit,
#: absorbed scores and context, ``wo``) is one call of its step
MLA_GROUPS = (("mla_attention", "mla", ("mla_decode", "mla_chunk"), ()),
              ) + MOE_GROUPS
#: jamba has no shared expert
JAMBA_GROUPS = MOE_GROUPS[:2] + MAMBA_GROUPS
DECODE_STEPS = 5


def tree_to(tree, device):
    """A copy of a parameter tree (dicts and lists of tensors) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def phase_serve_moe(torch, np):
    """The CLI's traffic at deepseek-moe-16b's full width (bf16) cut to
    ``MOE_SERVE_LAYERS`` layers (a dense first layer, then MoE layers of
    64 experts, top 6, and 2 shared experts) with chunked prefill, as
    ``phase_serve``: every request completes, the decode and prefill
    kernels together run once a layer per fused step, each at least once,
    every decode launch committing.  Prints the cut, the parameter draw's
    seconds (drawn on the card), the peak of allocated memory, the steps, tok/s and the
    phase's seconds.  Then profile-moe over second drains of the same
    engine.  Returns the launch counts."""
    import repro_torch.configs as configs
    from repro_torch.models import transformer

    t0 = time.time()
    full = configs.get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    params = transformer.init_lm(cfg, seed=0, device="cuda",
                                 draw_device="cuda")
    torch.cuda.synchronize()
    draw_s = time.time() - t0
    engine, counts, _ = phase_serve(torch, MOE_ARGV, "serve-moe",
                                    params=params, cfg=cfg)
    del params
    emit({"phase": "serve-moe-summary", "arch": cfg.name,
          "layers": cfg.n_layers,
          "cuts": [f"n_layers {full.n_layers} -> {cfg.n_layers}"],
          "parameters": sum(t.numel() for t in _leaves(engine.params)),
          "parameter_bytes": tree_bytes(engine.params), "draw_s": draw_s,
          "seconds": time.time() - t0})
    phase_profile(torch, np, engine, "profile-moe", 64, 256)
    profile_groups(torch, np, engine, "profile-moe-groups", MOE_GROUPS)
    return counts


def _kernels_under(event) -> int:
    """Kernels launched by a profiled host event and its children."""
    return len(event.kernels) + sum(_kernels_under(c)
                                    for c in event.cpu_children)


def profile_groups(torch, np, engine, phase, groups):
    """Where a serve step's device time goes by model function: a third
    drain under ``torch.profiler`` with host and device activity, each
    function of ``groups`` (:data:`MOE_GROUPS`, :data:`MAMBA_GROUPS`,
    :data:`JAMBA_GROUPS`, :data:`MLA_GROUPS`) wrapped in a
    ``record_function`` range for the
    drain only, so that the kernels each launches are summed by group; the
    attention kernels by name (:data:`KERNEL_GROUPS`), and the rest.  The
    host's tracing slows this drain, so its idle share is not read (the
    device-only profile line before it gives it).  Then the device time of
    a decode step alone (8 slots at lengths of the serve traffic,
    ``DECODE_STEPS`` steps under a device-only profile) beside its bytes
    bound: every parameter read once but the embedding table (8 rows of
    it), each slot's cached K/V (or latent) rows read once, the new rows
    and the logits written once, and the 8 slots' recurrent states read
    and
    written once, over the card's memory rate; and the kernels each group
    launches a layer in that drain (a layer: one call of one of the
    group's layer functions)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.hw import H100
    from repro_torch.models import mla, moe, ssm, transformer
    from repro_torch.serve.engine import Request

    modules = {"moe": moe, "ssm": ssm, "mla": mla}
    calls = {group: 0 for group, *_ in groups}

    def wrapped(fn, group, per_layer):
        def call(*args, **kwargs):
            calls[group] += per_layer
            with record_function(f"grp.{group}"):
                return fn(*args, **kwargs)
        return call

    rng = np.random.default_rng(5)
    for uid in range(PROFILE_REQUESTS):
        prompt = rng.integers(0, engine.cfg.vocab,
                              size=int(rng.integers(64, 257)))
        engine.submit(Request(uid=2000 + uid, prompt=prompt.astype(np.int32),
                              max_new_tokens=PROFILE_NEW))
    originals = {(mod, name): getattr(modules[mod], name)
                 for _, mod, per_layer, other in groups
                 for name in per_layer + other}
    first = engine.steps
    try:
        for group, mod, per_layer, other in groups:
            for name in per_layer + other:
                setattr(modules[mod], name, wrapped(
                    originals[mod, name], group, int(name in per_layer)))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.run_until_drained()
            torch.cuda.synchronize()
    finally:
        for (mod, name), fn in originals.items():
            setattr(modules[mod], name, fn)
    rows = prof.key_averages()
    kernels = [e for e in rows if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_group = {group: 0.0 for group, *_ in groups}
    for e in rows:
        if (e.is_user_annotation and str(e.device_type).endswith("CPU")
                and e.key.startswith("grp.")):
            by_group[e.key[4:]] += e.device_time_total / 1e3
    by_group["attention"] = sum(
        e.self_device_time_total for e in kernels
        if any(word in e.key for _, word in KERNEL_GROUPS)) / 1e3
    by_group["rest"] = busy_ms - sum(by_group.values())
    # the kernels each group launched, from the launching host calls inside
    # its ranges
    launched = {group: 0 for group, *_ in groups}
    for e in prof.events():
        if (e.is_user_annotation and str(e.device_type).endswith("CPU")
                and e.name.startswith("grp.")):
            launched[e.name[4:]] += _kernels_under(e)
    steps = engine.steps - first
    require(busy_ms > 0 and all(by_group[g] > 0 and calls[g] > 0
                                for g, *_ in groups),
            f"the grouped profile saw {busy_ms} ms, groups {by_group}, "
            f"calls {calls}")

    # a decode step alone, at 8 slots and the serve traffic's lengths
    cfg, params = engine.cfg, engine.params
    B, bs, max_len = 8, 16, 1024
    lengths = np.random.default_rng(8).integers(1, 512 + 32 + 1, size=B)
    cache = transformer.init_paged_cache(cfg, B, max_len, bs, "cuda")
    nb = max_len // bs
    bt = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                      device="cuda").reshape(B, nb)
    pos = torch.tensor(lengths - 1, dtype=torch.int32, device="cuda")
    tokens = torch.ones((B, 1), dtype=torch.int32, device="cuda")

    def step():
        return transformer.decode_step_paged(params, cfg, tokens, cache,
                                             pos, bt, block_size=bs)[0]

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as dprof:
        for _ in range(DECODE_STEPS):
            step()
        torch.cuda.synchronize()
    decode_ms = sum(e.self_device_time_total for e in dprof.key_averages()
                    if not e.is_user_annotation) / 1e3 / DECODE_STEPS
    table = params["embed"]["embedding"]
    # a token's row in every attention layer's pools: K and V, or the
    # latent c and k_rope
    row = sum(cache[key][:, 0, 0].numel() * cache[key].element_size()
              for key in ("k", "v", "c", "k_rope") if key in cache)
    state_bytes = sum(tree_bytes(cache[key]) for key in
                      ("ssm_state", "conv_state") if key in cache)
    decode_bytes = (tree_bytes(params) - tree_bytes(table)
                    + B * cfg.d_model * table.element_size()
                    + int(lengths.sum()) * row + B * row
                    + B * cfg.vocab_padded * 4 + 2 * state_bytes)
    del cache
    torch.cuda.empty_cache()
    bound_ms = decode_bytes / H100.hbm_bw * 1e3

    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "fused_steps": steps, "device_busy_ms": busy_ms,
          "device_ms_by_group": by_group,
          "share_by_group": {g: ms / busy_ms for g, ms in by_group.items()},
          "decode_step": {"slots": B, "lengths": lengths.tolist(),
                          "device_ms": decode_ms, "bytes": decode_bytes,
                          "state_bytes_read_and_written": 2 * state_bytes,
                          "bound_ms": bound_ms, "bound_by": "bytes",
                          "of_bound": bound_ms / decode_ms},
          "layer_calls": calls,
          "launches_per_layer": {g: launched[g] / max(calls[g], 1)
                                 for g in calls}})


def _parity_three_ways(torch, np, cfg, phase, cuts=(), t0=None,
                       kv_dtypes=("f32",), draw_device="cpu"):
    """``cfg`` in float32: chunked on the card, chunked on the CPU (the
    plain versions) and token by token on the card must give the same
    greedy streams, up to near ties, on pools of each of ``kv_dtypes``.
    Both sides hold the same weights: the seeded init drawn on
    ``draw_device`` and copied to the other.  Where the
    model has grouped-query attention layers, the card's chunked run must
    launch the decode and the prefill kernels; where it has none, no
    kernel.  Prints the phase's line for each pool dtype (``phase``, then
    ``phase-int8``), with ``cuts`` (how the config was cut to size)."""
    from repro_torch.kernels.flash_decode import kernel
    from repro_torch.models import transformer

    t0 = time.time() if t0 is None else t0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(20, 81)))
               .astype(np.int32) for _ in range(PARITY_REQUESTS)]
    drawn = transformer.init_lm(cfg, seed=0, device=draw_device,
                                draw_device=draw_device)
    other = tree_to(drawn, "cuda" if draw_device == "cpu" else "cpu")
    params = ({"cpu": drawn, "cuda": other} if draw_device == "cpu"
              else {"cpu": other, "cuda": drawn})
    del drawn, other
    cpu = params["cpu"]
    for kv_dtype in kv_dtypes:
        kw = dict(max_batch=4, max_len=96, block_size=16, kv_dtype=kv_dtype)
        chunked = dict(kw, prefill_chunk=16, prefill_budget=32)
        reset_counts(kernel)
        streams = {"cuda_chunked": _drain(cfg, params["cuda"], prompts,
                                          "cuda", **chunked)}
        counts = read_counts(kernel)
        if flash_layers(cfg):
            require(counts["flash_decode_paged"] > 0
                    and counts["flash_prefill_paged"] > 0,
                    f"the {phase} run skipped a kernel: {counts}")
        else:
            require(not any(counts.values()),
                    f"the {phase} run of a model without grouped-query "
                    f"attention launched kernels: {counts}")
        streams["cpu_chunked"] = _drain(cfg, cpu, prompts, "cpu", **chunked)
        streams["cuda_token"] = _drain(cfg, params["cuda"], prompts, "cuda",
                                       **kw)
        gaps = {name: _divergences(torch, cfg, cpu, prompts,
                                   streams["cpu_chunked"], streams[name], 16,
                                   kv_dtype)
                for name in ("cuda_chunked", "cuda_token")}
        emit({"phase": phase if kv_dtype == "f32"
              else f"{phase}-{kv_dtype}",
              "arch": cfg.name, "layers": cfg.n_layers,
              "dtype": "float32", "kv_dtype": kv_dtype, "cuts": list(cuts),
              "parameters": sum(t.numel() for t in _leaves(cpu)),
              "requests": len(prompts),
              "prompt_lens": [len(p) for p in prompts],
              "new_tokens": PARITY_NEW, "launches": counts,
              "streams_equal": {name: s == streams["cpu_chunked"]
                                for name, s in streams.items()},
              "divergences": gaps, "seconds": time.time() - t0})
    del params


def phase_parity_moe(torch, np):
    """deepseek-moe-16b at full width cut to ``MOE_PARITY_LAYERS`` layers
    (the dense first layer and two MoE layers), float32: chunked on the
    card (both kernels), chunked on the CPU (both plain versions) and
    token by token on the card must give the same greedy streams, up to
    near ties."""
    import repro_torch.configs as configs

    cfg = dataclasses.replace(configs.get_config("deepseek-moe-16b"),
                              n_layers=MOE_PARITY_LAYERS,
                              param_dtype="float32",
                              compute_dtype="float32")
    _parity_three_ways(torch, np, cfg, "parity-moe",
                       [f"n_layers 28 -> {MOE_PARITY_LAYERS}"])


def phase_serve_mla(torch, np):
    """The CLI's traffic at deepseek-v2-lite-16b's full width (bf16) cut
    to ``MLA_SERVE_LAYERS`` layers (each MLA over latent pools; a dense
    first layer, then MoE layers of 64 experts, top 6, and 2 shared
    experts) with ``CHUNKED_ARGV``'s traffic, as ``phase_serve``: every
    request completes, and no flash kernel launches (MLA attends over its
    latent pools in torch ops).  Prints the cut, the draw's seconds
    (weights drawn on the card), the parameter bytes, the latent pools'
    bytes beside the bytes of GQA pools (16 KV heads of 128) for the same
    blocks, the peak of allocated
    memory, the steps and tok/s; then profile-mla: the device-only
    profile of a second drain and the grouped one of a third (MLA
    attention, the MoE groups, the rest; a decode step beside its bytes
    bound)."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer

    t0 = time.time()
    full = configs.get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, n_layers=MLA_SERVE_LAYERS)
    params = transformer.init_lm(cfg, seed=0, device="cuda",
                                 draw_device="cuda")
    torch.cuda.synchronize()
    draw_s = time.time() - t0
    engine, counts, _ = phase_serve(torch, MLA_ARGV, "serve-mla",
                                    params=params, cfg=cfg)
    del params
    args = serve_cli.parse_args(MLA_ARGV)
    n_blocks = 1 + args.max_batch * args.max_len // args.block_size
    latent = (transformer.paged_block_bytes(cfg, args.block_size,
                                            args.kv_dtype) * n_blocks)
    gqa = (transformer.paged_block_bytes(
        dataclasses.replace(cfg, mla=None), args.block_size, args.kv_dtype)
        * n_blocks)
    pools = tree_bytes(transformer.init_paged_cache(
        cfg, args.max_batch, args.max_len, args.block_size, "cuda",
        kv_dtype=args.kv_dtype))
    require(pools == latent, f"the latent pools hold {pools} bytes, "
                             f"paged_block_bytes says {latent}")
    emit({"phase": "serve-mla-summary", "arch": cfg.name,
          "layers": cfg.n_layers,
          "cuts": [f"n_layers {full.n_layers} -> {cfg.n_layers}"],
          "draw_s": draw_s, "mla": dataclasses.asdict(cfg.mla),
          "parameters": sum(t.numel() for t in _leaves(engine.params)),
          "parameter_bytes": tree_bytes(engine.params),
          "pool_blocks": n_blocks, "latent_pool_bytes": latent,
          "gqa_pool_bytes_same_blocks": gqa, "gqa_over_latent": gqa / latent,
          "launches": counts, "seconds": time.time() - t0})
    phase_profile(torch, np, engine, "profile-mla", 64, 256)
    profile_groups(torch, np, engine, "profile-mla-groups", MLA_GROUPS)


def phase_parity_mla(torch, np):
    """deepseek-v2-lite-16b at full width cut to ``MLA_PARITY_LAYERS``
    layers (the dense first layer and two MoE layers), float32: chunked
    on the card, chunked on the CPU and token by token on the card give
    the same greedy streams, up to near ties, on f32 latent pools and
    then on int8 ones; no kernel launches."""
    import repro_torch.configs as configs

    full = configs.get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, n_layers=MLA_PARITY_LAYERS,
                              param_dtype="float32",
                              compute_dtype="float32")
    _parity_three_ways(torch, np, cfg, "parity-mla",
                       [f"n_layers {full.n_layers} -> {cfg.n_layers}"],
                       kv_dtypes=("f32", "int8"))


def phase_serve_mamba2(torch, np):
    """The CLI's traffic at mamba2-370m's full width (bf16, no attention)
    cut to ``MAMBA_SERVE_LAYERS`` Mamba-2 layers, with ``CHUNKED_ARGV``'s
    traffic: every request completes and no attention or commit kernel
    launches (phase_serve's rule for a model without attention layers).
    Prints the cut, the steps, tok/s, the peak of allocated memory and the
    phase's seconds; then profile-mamba2: the device-only profile of a
    second drain (kernels a step, the idle share), and the grouped one of
    a third (the mamba mixers against the rest, a decode step beside its
    bytes bound)."""
    import repro_torch.configs as configs
    from repro_torch.models import transformer

    t0 = time.time()
    full = configs.get_config("mamba2-370m")
    cfg = dataclasses.replace(full, n_layers=MAMBA_SERVE_LAYERS)
    params = transformer.init_lm(cfg, seed=0, device="cuda",
                                 draw_device="cuda")
    engine, _, _ = phase_serve(torch, MAMBA_ARGV, "serve-mamba2",
                               params=params, cfg=cfg)
    del params
    emit({"phase": "serve-mamba2-summary", "arch": cfg.name,
          "layers": cfg.n_layers,
          "cuts": [f"n_layers {full.n_layers} -> {cfg.n_layers}"],
          "parameters": sum(t.numel() for t in _leaves(engine.params)),
          "parameter_bytes": tree_bytes(engine.params),
          "seconds": time.time() - t0})
    phase_profile(torch, np, engine, "profile-mamba2", 64, 256)
    profile_groups(torch, np, engine, "profile-mamba2-groups", MAMBA_GROUPS)


def phase_parity_mamba2(torch, np):
    """mamba2-370m at full width and all 48 layers, float32: chunked on
    the card, chunked on the CPU and token by token on the card give the
    same greedy streams, up to near ties; no kernel launches."""
    import repro_torch.configs as configs

    cfg = dataclasses.replace(configs.get_config("mamba2-370m"),
                              param_dtype="float32",
                              compute_dtype="float32")
    _parity_three_ways(torch, np, cfg, "parity-mamba2")


def jamba_card_config():
    """jamba-1.5-large-398b as the card serves it: one superblock (7
    Mamba-2 layers and an attention layer, MoE on the odd layers) at full
    width, the routed experts cut from 16 to ``JAMBA_EXPERTS``."""
    import repro_torch.configs as configs

    cfg = configs.get_config("jamba-1.5-large-398b")
    return dataclasses.replace(
        cfg, n_layers=len(cfg.superblock),
        moe=dataclasses.replace(cfg.moe, n_routed=JAMBA_EXPERTS))


def phase_serve_jamba(torch, np):
    """One jamba superblock at full width (d 8192, 64 heads over 8 KV heads
    of 128, 7 Mamba-2 layers of 256 SSM heads, MoE on the odd layers)
    with its routed experts cut to 4 (:func:`jamba_card_config`; 16.2 B
    parameters, 32.3 GB in bf16), drawn on the card, and served with
    ``CHUNKED_ARGV``'s traffic
    as ``phase_serve``: every request completes, the decode and prefill
    kernels together launch once per fused step (one attention layer),
    each at least once, every decode launch committing.  Prints the
    parameter draw's seconds, the peak of allocated memory, the steps,
    tok/s and the phase's seconds; then profile-jamba: the device-only
    profile of a second drain and the grouped one of a third (expert
    products; routing, dispatch and combine; the mamba mixers; attention;
    the rest; a decode step beside its bytes bound).  Returns the launch
    counts."""
    from repro_torch.models import transformer

    t0 = time.time()
    resident = torch.cuda.memory_allocated()
    cfg = jamba_card_config()
    params = transformer.init_lm(cfg, seed=0, device="cuda",
                                 draw_device="cuda")
    torch.cuda.synchronize()
    draw_s = time.time() - t0
    engine, counts, _ = phase_serve(torch, JAMBA_ARGV, "serve-jamba",
                                    params=params, cfg=cfg)
    del params
    emit({"phase": "serve-jamba-summary", "arch": cfg.name,
          "layers": cfg.n_layers, "routed_experts": cfg.moe.n_routed,
          "parameters": sum(t.numel() for t in _leaves(engine.params)),
          "parameter_bytes": tree_bytes(engine.params), "draw_s": draw_s,
          "allocated_before_draw_bytes": resident,
          "seconds": time.time() - t0})
    phase_profile(torch, np, engine, "profile-jamba", 64, 256)
    profile_groups(torch, np, engine, "profile-jamba-groups", JAMBA_GROUPS)
    return counts


def phase_parity_jamba(torch, np):
    """One jamba superblock at its full mixer widths (d 8192, 64 heads
    over 8 KV heads, 256 SSM heads), float32, all 16 experts, top 2, with
    ``d_ff`` and ``d_ff_expert`` cut to ``JAMBA_PARITY_FF`` (5.79 B
    parameters, 23.1 GB on each side; drawn on the card and copied to the
    CPU): chunked on the card, chunked on the CPU and token by token on
    the card give the same greedy streams, up to near ties."""
    import repro_torch.configs as configs

    full = configs.get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(
        full, n_layers=len(full.superblock), d_ff=JAMBA_PARITY_FF,
        moe=dataclasses.replace(full.moe, d_ff_expert=JAMBA_PARITY_FF),
        param_dtype="float32", compute_dtype="float32")
    _parity_three_ways(torch, np, cfg, "parity-jamba", [
        f"n_layers {full.n_layers} -> {cfg.n_layers} (one superblock)",
        f"d_ff {full.d_ff} -> {cfg.d_ff}",
        f"d_ff_expert {full.moe.d_ff_expert} -> {cfg.moe.d_ff_expert}"],
        draw_device="cuda")


# -- tensor parallelism -------------------------------------------------------


#: the head-sharded decode's timing row: row 1's qwen3-1.7b serve shapes
SHARDED_N = 2
#: the mesh phases' shapes, as ranks sharing the one card over gloo, and
#: their requests: serve-mesh's are the first of CHUNKED_ARGV's traffic,
#: parity-mesh's as many as the reference's mesh check serves with int8
#: pools and sharing
SERVE_MESHES = ("1x2", "2x2")
SERVE_MESH_REQUESTS = 8
PARITY_MESHES = ("1x1", "2x1", "1x2", "2x2")
PARITY_MESH_REQUESTS = 3
#: the seconds one mesh's ranks may take (each takes 20-40 s on an H100),
#: so that a hung mesh fails the script well inside its limit
MESH_TIMEOUT = 240


def _sharded_inputs(torch, ref, B, KV, G, D, bs, nb, q_dtype, pool_dtype,
                    valid, seed):
    """q in ``q_dtype`` and pools in ``pool_dtype`` (int8 quantized per row,
    with scales), a shuffled table and the lengths, made on the card."""
    q, kp, vp, bt, vl = paged_inputs(torch, B, KV, G, D, bs, nb,
                                     torch.float32, valid, seed)
    kp, vp, ks, vs = as_pools(torch, ref, kp, vp, pool_dtype)
    return (q.to(q_dtype), kp, vp, bt, vl), (ks, vs)


def check_sharded_decode(torch, np, kernel, ref):
    """Kernel 2.4 on the card: for every (q, pool) pair and head shape,
    the slices (i, n) for n in 1, 2, 4 (where KV divides), concatenated,
    bit-equal to the unsharded launch; each slice within ``decode_close``
    of its plain version; the commit given each row's amax over all heads
    bit-equal, codes and scales, to the unsharded commit's head slice; and
    the reference's validation errors."""
    B, bs = 8, 16
    rng = np.random.default_rng(21)
    heads = {**{arch: (h, 16 if arch == "gpt2-124m" else 64)
                for arch, h in ARCH_HEADS.items()},
             **{name: (h, 16) for name, h in SMALL_HEADS.items()}}
    cases, worst = 0, 0.0
    for name, ((KV, G, D), nb) in heads.items():
        valid = rng.integers(1, nb * bs + 1, size=B)
        valid[:2] = (1, nb * bs)
        for q_dtype, pool_dtype in kernel.POOL_PAIRS:
            args, (ks, vs) = _sharded_inputs(torch, ref, B, KV, G, D, bs, nb,
                                             q_dtype, pool_dtype,
                                             valid.tolist(), seed=cases)
            full = kernel.flash_decode_paged(*args, ks, vs)
            for n in (1, 2, 4):
                if KV % n:
                    continue
                parts = [kernel.flash_decode_paged(*args, ks, vs,
                                                   head_shard=(i, n))
                         for i in range(n)]
                torch.cuda.synchronize()
                pair = f"{dtype_name(q_dtype)}/{dtype_name(pool_dtype)}"
                require(torch.equal(torch.cat(parts, dim=1), full),
                        f"head slices of {name} {pair} n={n} != the "
                        f"unsharded decode")
                q, kp, vp, bt, vl = args
                for i, part in enumerate(parts):
                    h = ref.head_slice((i, n), KV)
                    want = ref.flash_decode_paged_ref(
                        q[:, h], kp[:, :, h], vp[:, :, h], bt, vl, ks, vs)
                    err, ok = decode_close(torch, part, want)
                    require(ok, f"slice ({i}, {n}) of {name} {pair}: max "
                                f"abs err {err} over {CLOSE_TOL}")
                    worst = max(worst, err)
                cases += 1
    commits = check_sharded_commit(torch, np, kernel, ref, heads)
    q, kp, vp, bt, vl = _sharded_inputs(torch, ref, B, 8, 2, 128, bs, 4,
                                        torch.float32, torch.float32,
                                        [1] * B, seed=0)[0]
    errors = {}
    for shard, word in (((0, 3), "not divisible"), ((2, 2), "outside")):
        try:
            kernel.flash_decode_paged(q, kp, vp, bt, vl, head_shard=shard)
        except ValueError as e:
            errors[str(shard)] = str(e)
        require(word in errors.get(str(shard), ""),
                f"head_shard={shard} did not raise '{word}'")
    emit({"phase": "kernel-sharded", "kernel": "flash_decode_paged_sharded",
          "heads": {name: list(h) for name, (h, _) in heads.items()},
          "pairs": [f"{dtype_name(a)}/{dtype_name(b)}"
                    for a, b in kernel.POOL_PAIRS],
          "bit_equal_concatenations": cases, "max_abs_err": worst,
          "tol": CLOSE_TOL, "commit_slices_bit_equal": commits,
          "errors": errors})
    return worst


def check_sharded_commit(torch, np, kernel, ref, heads):
    """The int8 commit of one decode row a slot (and a chunk of 16 rows)
    given each row's amax over all heads: every head slice's codes and
    scales bit-equal to the unsharded commit's.  Returns the slices
    checked."""
    checked = 0
    for name, ((KV, _, D), nb) in heads.items():
        for dtype in (torch.float32, torch.bfloat16):
            for C in (1, 16):
                B, bs = 8, 16
                gen = torch.Generator(device="cuda").manual_seed(checked)
                kw = dict(device="cuda", generator=gen)
                new = [torch.randn((B, C, KV, D), **kw).to(dtype)
                       for _ in range(2)]
                n_blocks = 1 + B * nb
                pools = [torch.zeros((n_blocks, bs, KV, D), dtype=torch.int8,
                                     device="cuda") for _ in range(2)]
                scales = [torch.zeros((n_blocks, bs), device="cuda")
                          for _ in range(2)]
                bt = shuffled_tables(torch, gen, B, nb, n_blocks)
                q_start = torch.randint(0, nb * bs - C + 1, (B,), **kw).to(
                    torch.int32)
                q_len = torch.full((B,), C, dtype=torch.int32, device="cuda")
                kernel.commit_paged(*new, *pools, bt, q_start, q_len,
                                    *scales)
                amax = dict(k_amax=ref.row_amax(new[0]),
                            v_amax=ref.row_amax(new[1]))
                for n in (2, 4):
                    if KV % n:
                        continue
                    for i in range(n):
                        h = ref.head_slice((i, n), KV)
                        local = [torch.zeros((n_blocks, bs, KV // n, D),
                                             dtype=torch.int8,
                                             device="cuda") for _ in pools]
                        loc_s = [torch.zeros_like(s) for s in scales]
                        kernel.commit_paged(
                            *(x[:, :, h].contiguous() for x in new), *local,
                            bt, q_start, q_len, *loc_s, **amax)
                        torch.cuda.synchronize()
                        require(all(torch.equal(a, p[:, :, h])
                                    for a, p in zip(local, pools))
                                and all(torch.equal(a, s) for a, s in
                                        zip(loc_s, scales)),
                                f"commit slice ({i}, {n}) of {name} "
                                f"{dtype_name(dtype)} C={C} != the "
                                f"unsharded commit")
                        checked += 1
    return checked


def sharded_decode_timing(torch, np, kernel, ref, arch="qwen3-1.7b"):
    """The n=2 slice of kernel 2.4 at row 1's serve shapes of ``arch`` (8
    slots, 64 blocks of 16, lengths 1..544, bf16), as a rank of a 1x2 mesh
    calls it: its 4 KV heads of q and of its own pools.  Beside it: its
    bound, the plain version, SDPA over the local heads gathered
    beforehand, the head_shard slice read in place from the full pools,
    and the unsharded launch over all 8 heads."""
    import torch.nn.functional as F

    from repro_torch.launch.mesh import MeshShape

    B, bs, nb = 8, 16, 64
    KV, G, D = ARCH_HEADS[arch]
    valid = np.random.default_rng(8).integers(1, 512 + 32 + 1, size=B)
    full = paged_inputs(torch, B, KV, G, D, bs, nb, torch.bfloat16,
                        valid.tolist(), seed=9)
    q, k_pool, v_pool, bt, vl = full
    h = ref.head_slice((0, SHARDED_N), KV)
    local = (q[:, h].contiguous(), k_pool[:, :, h].contiguous(),
             v_pool[:, :, h].contiguous(), bt, vl)
    mesh = MeshShape(1, SHARDED_N)

    def sharded():
        return kernel.flash_decode_paged_sharded(*local, mesh=mesh)

    out = sharded()
    want = ref.flash_decode_paged_ref(*local)
    err, ok = decode_close(torch, out, want)
    require(ok, f"the sharded decode at {arch} serve shapes: max abs err "
                f"{err}")
    require(torch.equal(out, kernel.flash_decode_paged(
        *full, head_shard=(0, SHARDED_N))), "in-place slice != local pools")

    kvl = KV // SHARDED_N
    S = nb * bs
    k = local[1][bt.long()].reshape(B, S, kvl, D).transpose(1, 2)
    v = local[2][bt.long()].reshape(B, S, kvl, D).transpose(1, 2)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qh = local[0].reshape(B, kvl * G, 1, D)
    mask = (torch.arange(S, device="cuda")[None, :] < vl[:, None])
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (library().reshape(out.shape).float()
               - want.float()).abs().max().item()
    require(lib_err <= 2 * TOLERANCE["bfloat16"],
            f"SDPA yardstick disagrees: {lib_err}")
    bound_ms, bound_by = bound(ref.work_terms(local[0], local[1], bt, valid),
                               "bfloat16")
    row = {
        "max_abs_err": err,
        "ms": device_ms(torch, sharded),
        "plain_ms": device_ms(torch, lambda: ref.flash_decode_paged_ref(
            *local)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(torch, library),
    }
    extra = {
        "head_shard_in_place_ms": device_ms(
            torch, lambda: kernel.flash_decode_paged(
                *full, head_shard=(0, SHARDED_N))),
        "unsharded_ms": device_ms(torch,
                                  lambda: kernel.flash_decode_paged(*full)),
    }
    emit({"phase": "kernel-sharded", "kernel": "flash_decode_paged_sharded",
          "shapes": f"serve {arch}, slice (0, 2)", "B": B, "KV": KV,
          "local_KV": kvl, "G": G, "D": D, "bs": bs, "nb": nb,
          "dtype": "bfloat16", "valid_len": valid.tolist(), **row, **extra})
    return row


def _first_divergence(got, want):
    """(uid, index) of the first token where ``got`` leaves ``want``, or
    None."""
    for uid, (a, b) in enumerate(zip(got, want)):
        if a != b:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return uid, i
    return None


def phase_serve_mesh(torch, params):
    """qwen3-1.7b at full width and all 28 layers, bf16, chunked as
    ``CHUNKED_ARGV`` with its first ``SERVE_MESH_REQUESTS`` requests, on
    1x2 and 2x2 meshes of ranks sharing the card over gloo, and unsharded
    on the card for the streams: every request completes; on every rank
    the head-sharded decode launches once per layer per decode step, over
    KV / M heads, and with the prefill kernel once per layer per fused
    step.  Prints each rank's launches, backend, collectives a step,
    bytes staged through the host, wall time and tok/s, and how many
    streams equal the unsharded engine's (bf16 row-parallel sums may flip
    near ties, so no bar on that).  The ranks cut their shards from
    serve-chunked's ``params``, shared through CUDA IPC, so that none
    draws the 2 B-parameter init again.  Every decode launch commits its
    slots' rows; with two data ranks the commit kernel also writes the
    other rank's rows, once a layer and fused step.  Returns the launches
    of the head-sharded decode and of the commit kernel, over every rank
    of both meshes."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve as serve_cli

    argv = CHUNKED_ARGV + ["--requests", str(SERVE_MESH_REQUESTS)]
    args = serve_cli.parse_args(argv)
    base = serve_cli.serve(args, serve_cli.make_engine(args, params=params))
    want = [r["tokens"] for r in base["requests"]]
    launches = commits = 0
    for shape in SERVE_MESHES:
        args = serve_cli.parse_args(argv + ["--mesh", shape])
        cfg = (configs.get_smoke_config(args.arch) if args.smoke
               else configs.get_config(args.arch))
        L = cfg.n_layers
        t0 = time.time()
        report = serve_cli.serve_on_mesh(args, params,
                                         timeout=MESH_TIMEOUT)
        seconds = time.time() - t0
        stats, reqs = report["stats"], report["requests"]
        require(len(reqs) == args.requests and report["rejected"] == 0
                and all(r["new_tokens"] == args.max_new for r in reqs),
                f"mesh {shape}: {len(reqs)} of {args.requests} requests "
                f"completed")
        steps = stats["fused_steps"]
        data, model = (int(n) for n in shape.split("x"))
        for row in report["mesh_ranks"]:
            chunk_steps = row["flash_prefill_paged"] // L
            require(row["flash_prefill_paged"] == L * chunk_steps
                    and row["flash_decode_paged_sharded"]
                    == L * (steps - chunk_steps)
                    and row["flash_decode_paged"]
                    == row["flash_decode_paged_sharded"] > 0,
                    f"mesh {shape} rank {row['rank']}: launches {row} for "
                    f"{steps} fused steps of {L} layers")
            require(row["local_kv_heads"] == cfg.n_kv_heads // model,
                    f"rank {row['rank']} holds {row['local_kv_heads']} KV "
                    f"heads")
            require(row["decode_commits"] == row["flash_decode_paged"]
                    and row["commit_paged"] == (L * steps if data > 1
                                                else 0),
                    f"mesh {shape} rank {row['rank']}: commits {row} for "
                    f"{steps} fused steps of {L} layers")
            launches += row["flash_decode_paged_sharded"]
            commits += row["commit_paged"]
        got = [r["tokens"] for r in reqs]
        emit({"phase": "serve-mesh", "arch": cfg.name, "mesh": shape,
              "backend": report["mesh_backend"], "layers": L,
              "dtype": cfg.compute_dtype, "requests": len(reqs),
              "new_tokens": stats["new_tokens"], "fused_steps": steps,
              "tok_s": stats["tok_s"], "wall_s": stats["wall_s"],
              "device_lane_utilization": stats["device_lane_utilization"],
              "ranks": [{**row, "collectives_per_step": row["calls"] / steps}
                        for row in report["mesh_ranks"]],
              "unsharded_tok_s": base["stats"]["tok_s"],
              "streams_equal_unsharded": sum(a == b for a, b in
                                             zip(got, want)),
              "first_divergence": _first_divergence(got, want),
              "seconds": seconds})
    return launches, commits


def phase_parity_mesh(torch):
    """The port's mesh check on the card, in float32: gpt2-124m at full
    width, qwen3-1.7b at full width cut to 4 layers (as parity-int8),
    deepseek-moe-16b at full width cut to 3 layers (as parity-moe; on a
    model axis of 2 each rank holds 32 of the 64 experts), mamba2-370m at
    full width cut to ``MAMBA_MESH_LAYERS`` layers (on a model axis of 2
    each rank holds 16 of the 32 SSM heads), jamba-1.5-large-398b at its
    smoke shapes (four ranks sharing one card cannot each hold a
    full-width superblock: on a 2-D mesh every rank holds the mamba
    mixers whole), deepseek-v2-lite-16b at its smoke shapes (MLA heads
    over ``model``, the latent pools whole on every rank), gpt2-124m
    with int8 pools and prefix sharing, and gpt2-124m self-speculating
    (k 2; every shape drafts as many tokens as the unsharded engine), each
    on 1x1, 2x1, 1x2 and 2x2 against the unsharded card engine: the greedy
    streams equal token for token, and the int8 pools on every rank within
    the check's rule (scales the same bits on every rank, codes within one
    step and scales within 1e-2 of the unsharded pools' head slice).
    Returns the commit kernel's launches on the ranks of the int8 workload
    (the other data rank's rows, where there are two)."""
    import repro_torch.configs as configs
    from repro_torch.serve import mesh_check

    f32 = dict(param_dtype="float32", compute_dtype="float32")
    gpt2 = dataclasses.replace(configs.get_config("gpt2-124m"), **f32)
    qwen3 = dataclasses.replace(configs.get_config("qwen3-1.7b"),
                                n_layers=4, **f32)
    moe = dataclasses.replace(configs.get_config("deepseek-moe-16b"),
                              n_layers=MOE_PARITY_LAYERS, **f32)
    mamba2 = dataclasses.replace(configs.get_config("mamba2-370m"),
                                 n_layers=MAMBA_MESH_LAYERS, **f32)
    workloads = (
        ("gpt2", "gpt2-124m", {"config": gpt2}),
        ("qwen3", "qwen3-1.7b", {"config": qwen3}),
        ("mamba2", "mamba2-370m", {"config": mamba2}),
        ("moe", "deepseek-moe-16b", {"config": moe}),
        ("mla", "deepseek-v2-lite-16b", {}),
        ("jamba", "jamba-1.5-large-398b", {}),
        ("gpt2-int8-shared", "gpt2-124m",
         {"config": gpt2, "kv_dtype": "int8", "share_prefixes": True,
          "shared_prefix_len": 6}),
        ("gpt2-spec", "gpt2-124m",
         {"config": gpt2, "spec_k": 2, "draft": "gpt2-124m"}),
    )
    t0 = time.time()
    verdict = mesh_check.run_check(
        PARITY_MESHES, workloads, requests=PARITY_MESH_REQUESTS,
        max_new=PARITY_NEW, device="cuda", timeout=MESH_TIMEOUT)
    emit({"phase": "parity-mesh", "dtype": "float32", "ok": verdict["ok"],
          "diffs": verdict["diffs"], "shapes": verdict["shapes"],
          "workloads": verdict["workloads"], "seconds": time.time() - t0})
    require(verdict["ok"], f"mesh parity on the card: {verdict['diffs']}")
    int8 = verdict["workloads"]["gpt2-int8-shared"]
    commits = sum(r["commit_launches"] for shape in PARITY_MESHES
                  for r in int8[shape]["ranks"])
    require(commits > 0, "the int8 mesh runs never launched the commit "
                         "kernel")
    jamba = sum(r["decode_sharded_launches"] for shape in PARITY_MESHES
                for r in verdict["workloads"]["jamba"][shape]["ranks"])
    require(jamba > 0, "the jamba mesh runs never launched kernel 2.4")
    spec = verdict["workloads"]["gpt2-spec"]
    require(all(spec[s]["drafted_tokens"] == spec["none"]["drafted_tokens"]
                > 0 for s in PARITY_MESHES),
            f"gpt2-spec drafted differently across meshes: {spec}")
    return commits, jamba


# -- the train stack ----------------------------------------------------------


#: the train phase's job: qwen3-1.7b at full width (28 layers, d 2048,
#: 2.03 B parameters, bf16 params with an fp32 master), 4 rows of 2048
#: tokens, every layer recomputed in the backward pass; no checkpoint (the
#: state is about 32 GB)
TRAIN_JOB = dict(arch="qwen3-1.7b", smoke=False, steps=6, batch=4, seq=2048,
                 remat="full", device="cuda", log_every=1)
#: train profiles from this step to the last (their times are left out of
#: the step median); the profiler starts before the first and stops after
#: the last, outside the interval its idle share is taken over
TRAIN_PROFILED_FROM = 4
#: train's device time by words of the kernel's name (lower case), the
#: first group that matches: the products in fp32 (the flash tiles'
#: einsums; TF32 is off) and in bf16 (the projections, FFNs and LM head),
#: copies and casts, the other elementwise kernels, reductions
TRAIN_GROUPS = (("gemm_fp32", ("f32f32", "sgemm")),
                ("gemm_bf16", ("bf16", "nvjet", "gemm")),
                ("copy", ("copy", "memcpy", "memset", "catarray")),
                ("elementwise", ("elementwise",)),
                ("reduce", ("reduce", "softmax", "norm")))
#: the train-resume phase's job: gpt2-124m at full width (about 2 GB of
#: state), the paper's training example's rows; a checkpoint every 3
#: steps and one injected fault at step 4
RESUME_JOB = dict(arch="gpt2-124m", smoke=False, steps=6, batch=8, seq=512,
                  remat="full", device="cuda", log_every=1, ckpt_every=3)
RESUME_FAULT_STEP = 4
#: the most train-resume's faulted run may allocate at its peak, against
#: the clean run's
RESUME_PEAK_RATIO = 1.2
#: parity-train's bounds, card against CPU (f32, TF32 off), for every
#: arch; the moments carry the gradients' bound through their update
#: (``m`` at ``(1 - b1) atol``, ``sqrt(v)`` at ``sqrt(1 - b2) atol``)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
#: the card's AdamW update (params after less params before) against the
#: update replayed on the CPU from the card's gradients: at most this
#: share of the step's lr apart, and the replay's largest move at least
#: :data:`UPDATE_MIN_SHARE` of it (an update that does nothing, or moves
#: the other way, parts by the whole lr or twice it)
UPDATE_TOL_SHARE = 0.1
UPDATE_MIN_SHARE = 0.5
#: how long train-resume's fault waits for the step-3 checkpoint's commit
COMMIT_WAIT_S = 120
#: parity-train's shape: the reference's smoke shape, 2 rows of 32 tokens,
#: and its batch's seed
PARITY_TRAIN_SEQ, PARITY_TRAIN_BATCH = 32, 2
PARITY_TRAIN_SEED = 0
#: the H100's dense bf16 peak (NVIDIA's data sheet), for the model-flops
#: share of a train step
BF16_PEAK_FLOPS = 989e12
#: aten ops that may accumulate with atomics on CUDA, so that a step that
#: runs them need not be bit-for-bit repeatable (the ops PyTorch's
#: ``torch.use_deterministic_algorithms`` names for CUDA); ``index_put``
#: counts only with ``accumulate=True``
NONDETERMINISTIC_CUDA_OPS = ("index_add", "index_add_", "scatter_add",
                             "scatter_add_", "scatter_reduce",
                             "index_put(accumulate)", "put_", "cumsum",
                             "index_copy")


#: parity-train-mesh: the models (f32, TF32 off) and the meshes of ranks
#: that train them, against the one-rank card step: gpt2-124m at full
#: width, qwen3-1.7b cut to 4 layers (as parity-mesh) and deepseek-moe-16b
#: cut to its dense first layer and one MoE layer of 64 experts (32 a rank
#: on a model axis of 2); 2 steps of 4 rows of 32 tokens (deepseek: 768
#: assignments over 64 experts of capacity 16, which binds)
TRAIN_MESH_MODELS = (("gpt2-124m", None), ("qwen3-1.7b", 4),
                     ("deepseek-moe-16b", 2))
TRAIN_MESH_SHAPES = ("1x1", "2x1", "1x2", "2x2")
TRAIN_MESH_STEPS, TRAIN_MESH_BATCH, TRAIN_MESH_SEQ = 2, 4, 32
#: where ZeRO off runs beside ZeRO on, bit-equal, a model to its shapes
#: (deepseek's unsharded state on four ranks and the one-rank references
#: the ranks read would not fit the card beside each other)
TRAIN_MESH_ZERO_OFF = {"gpt2-124m": ("2x2",), "qwen3-1.7b": ("2x2",),
                       "deepseek-moe-16b": ()}
#: train-mesh: the trainer for qwen3-1.7b at full width cut to 4 layers
#: (``--layers 4``), bf16 params with fp32 masters, 4 x 512 tokens, ZeRO
#: on: one step through ``launch.train.train`` on one device, then 4
#: steps of its per-rank path ``launch.train.train_on`` on a 2x2 mesh of
#: ranks sharing the card; the mesh's first loss within this many bf16
#: ulps of the one-device step's (the same seeded weights and batch)
TRAIN_MESH_BF16 = dict(layers=4, batch=4, seq=512, steps=4, shape="2x2")
TRAIN_MESH_LOSS_ULPS = 2
TRAIN_MESH_TIMEOUT = 600
#: the jobs of each spawn of 2x2 ranks, in order (the bf16 run first, so
#: that rank 0 builds its state on a card its process holds nothing of):
#: card memory the ranks shared through CUDA IPC is not all given back
#: while they live (three f32 models in one spawn ran the card out of
#: memory on the third), so deepseek, the largest, starts from fresh
#: processes
TRAIN_MESH_SPAWNS = (("train-mesh", "gpt2-124m", "qwen3-1.7b"),
                     ("deepseek-moe-16b",))


#: whisper-train's job: whisper-large-v3 at full width (32 + 32 layers,
#: 2.02 B parameters, bf16 params with an fp32 master and moments), 4 x
#: 2048 decoder tokens over 512 post-conv frames a row, remat full; 4
#: steps, the last profiled (61,484 kernels a step to parse)
WHISPER_TRAIN_JOB = dict(TRAIN_JOB, arch="whisper-large-v3", steps=4)
WHISPER_PROFILED_STEP = 3
#: whisper-decode's traffic: 8 slots, Whisper's 30-s window of 1500
#: encoder frames, a 4-token prompt, 128 greedy tokens, a cache of 448
#: rows (Whisper's decoder limit)
WHISPER_B, WHISPER_FRAMES, WHISPER_PROMPT = 8, 1500, 4
WHISPER_NEW, WHISPER_MAX_LEN = 128, 448
#: whisper-decode's check against the teacher-forced forward on the
#: stream's own tokens, both in bf16: over its first tokens the step
#: logits within this share of the forward's largest (an H100 run read
#: 0.018: 0.094 of 5.16), and its tokens the forward's argmax wherever the
#: forward's top-2 gap is over twice the largest logit difference (where
#: no difference that small can flip it)
WHISPER_CHECKED, WHISPER_LOGITS_SHARE = 16, 0.05
#: whisper-decode's second run profiles this many decode steps from this
#: one (kernels a step, device time by group, the idle share)
WHISPER_PROFILED_FROM, WHISPER_PROFILED = 32, 8
#: timing-whisper's split_rows launch variants at the cross shape
WHISPER_SPLITS = (128, 256, 512, 768, 1024, 1536)
#: parity-whisper: the smoke config's decode steps card against CPU
WHISPER_PARITY_STEPS = 16


def _op_census(torch, fn):
    """``fn()``'s result and the names of the aten ops it (and the
    backward it runs) dispatched, ``index_put`` marked when it
    accumulates."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if "index_put" in name and (kwargs.get("accumulate") or (
                    len(args) > 3 and args[3] is True)):
                name = "index_put(accumulate)"
            self.ops.add(name)
            return func(*args, **kwargs)

    with Census() as census:
        out = fn()
    return out, sorted(census.ops)


def _tree_diff(torch, got, want):
    """(max abs difference, leaves that differ) of two trees of tensors,
    compared on the CPU in fp32."""
    from repro_torch.optim.adamw import tree_leaves

    worst, differ = 0.0, 0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        d = (g.detach().float().cpu() - w.detach().float().cpu()).abs()
        if d.numel() and float(d.max()) > 0:
            differ += 1
            worst = max(worst, float(d.max()))
    return worst, differ


def _worst(torch, got, want, rtol, atol):
    """(the largest ``|got - want| / (atol + rtol |want|)`` over two trees,
    1 or less where ``allclose`` holds, and the leaf index it is at)."""
    from repro_torch.optim.adamw import tree_leaves

    worst, at = 0.0, None
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        r = float(((g - w).abs() / (atol + rtol * w.abs())).max())
        if r > worst:
            worst, at = r, i
    return worst, at


def _trees_close(torch, got, want, rtol, atol) -> bool:
    return _worst(torch, got, want, rtol, atol)[0] <= 1.0


def _update_diff(torch, new, old, want_new, want_old):
    """(the largest difference of the two updates ``new - old`` and
    ``want_new - want_old`` over two pairs of trees, the largest element
    of the second update), in fp32 on the CPU."""
    from repro_torch.optim.adamw import tree_leaves

    worst, largest = 0.0, 0.0
    for n, o, wn, wo in zip(*map(tree_leaves, (new, old, want_new,
                                               want_old))):
        d = n.detach().float().cpu() - o.detach().float().cpu()
        w = wn.detach().float().cpu() - wo.detach().float().cpu()
        worst = max(worst, float((d - w).abs().max()))
        largest = max(largest, float(w.abs().max()))
    return worst, largest


def dense_model_flops(cfg, params, job):
    """(model flops of one train step, the formula): ``6 N T``, N the
    config's parameter count and T the step's tokens."""
    n = cfg.param_count()
    tokens = job.batch * job.seq
    return 6 * n * tokens, f"6 N T, N {n:.0f}, T {tokens}"


def whisper_model_flops(cfg, params, job):
    """(model flops of one train step, the formula) for the
    encoder-decoder: ``6 (N_enc F + N_dec T)``, F the step's encoder
    frames and T its decoder tokens; N_enc the parameters a frame meets
    (the encoder's layers and norm, and each decoder layer's cross
    ``wk``/``wv``, which project the encoder's output), N_dec those a
    token meets (the decoder's other parameters and the LM head; the
    embedding is a lookup)."""
    from repro_torch.optim.adamw import tree_leaves

    def count(tree):
        return sum(t.numel() for t in tree_leaves(tree))

    cross = sum(count(p["xattn"][k]) for p in params["dec_layers"]
                for k in ("wk", "wv"))
    n_enc = count(params["enc_layers"]) + count(params["enc_norm"]) + cross
    n_dec = (count(params["dec_layers"]) - cross
             + count(params["final_norm"]) + count(params["lm_head"]))
    frames = job.batch * max(job.seq // 4, 8)
    tokens = job.batch * job.seq
    return (6 * (n_enc * frames + n_dec * tokens),
            f"6 (N_enc F + N_dec T), N_enc {n_enc}, F {frames}, "
            f"N_dec {n_dec}, T {tokens}")


def phase_train(torch, np, kernel, card, job_kw=TRAIN_JOB, phase="train",
                model_flops=dense_model_flops,
                profiled_from=TRAIN_PROFILED_FROM):
    """``launch.train.train`` on ``job_kw`` (:data:`TRAIN_JOB`: qwen3-1.7b
    at full width, 6 steps of 4 x 2048 tokens, remat full; or
    :data:`WHISPER_TRAIN_JOB`).  Requires a finite loss
    and grad norm at every step, every leaf of the fp32 master moved off
    its init, the peak of allocated memory under the card's memory and no
    flash kernel launched (the train path reaches none).  Prints the
    step's ms (median of the unprofiled steps after the first), tokens/s,
    ``6 N T`` over the step time as a share of the bf16 peak, the peak
    memory, and, for the steps from ``profiled_from`` on under
    ``torch.profiler`` (device activity), kernels a step, their device
    time by :data:`TRAIN_GROUPS`, and the device's idle share over those
    steps' interval, as the profile phases take it: one less their device
    time over the interval's wall time (null, and flagged, should the
    device time exceed it); and for each step the host's stalls that
    leave the device idle, its milliseconds in Python's garbage collector
    and the caching allocator's retries.  ``model_flops`` gives the step's
    model flops and their formula, printed beside their share of the
    bf16 peak."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launch
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import steps as steps_mod

    t0 = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel)
    job = launch.TrainJob(**job_kw)
    stamps, window, host = [], [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    # the host's own stalls, read at each step's start: milliseconds in
    # Python's garbage collector, and the caching allocator's retries (a
    # failed cudaMalloc that frees the cache and tries again)
    gc_ms, gc_start = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_start[0]) * 1e3

    def host_mark():
        host.append((gc_ms[0], torch.cuda.memory_stats().get(
            "num_alloc_retries", 0)))

    def hook(step):  # before each step: the previous step has ended
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        host_mark()
        if step == profiled_from:
            prof.start()
            window.append(time.perf_counter())

    gc.callbacks.append(on_gc)
    try:
        out = launch.train(job, hook=hook)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        host_mark()
    finally:
        gc.callbacks.remove(on_gc)
    window.append(stamps[-1])
    prof.stop()
    counts = read_counts(kernel)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    step_s = np.diff(stamps)
    timed = step_s[1:profiled_from]
    step_ms = statistics.median(timed) * 1e3
    hist = out["history"]
    require([m["step"] for m in hist] == list(range(job.steps)),
            f"train logged steps {[m['step'] for m in hist]}")
    require(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                for m in hist), f"train: a loss or grad norm is not "
            f"finite: {hist}")
    require(not any(counts.values()),
            f"{phase} launched a kernel of the serve path: {counts}")
    require(peak < total, f"{phase} peak {peak} B over the card's {total}")
    cfg = out["cfg"]
    state = out["state"]
    del out
    init = steps_mod.init_model(cfg, seed=job.seed, device="cuda",
                                draw_device="cuda")
    moved = [not torch.equal(m, p.float()) for m, p in zip(
        tree_leaves(state["opt"]["master"]), tree_leaves(init))]
    changed = sum(int((a != b).sum()) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(init)))
    n_params = sum(p.numel() for p in tree_leaves(init))
    flops, flops_formula = model_flops(cfg, init, job)
    del init, state
    torch.cuda.empty_cache()
    require(all(moved), f"{phase}: {moved.count(False)} of {len(moved)} "
            f"master leaves never moved")
    profiled = job.steps - profiled_from
    dev = _device_groups(prof, profiled, top=8)
    busy_ms = dev["device_busy_ms"] * profiled
    require(busy_ms > 0, f"the profiler saw no device time in {phase}")
    window_ms = (window[1] - window[0]) * 1e3
    idle = 1.0 - busy_ms / window_ms
    tokens = job.batch * job.seq
    n_model = cfg.param_count()
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "parameters": n_params,
          "param_count": n_model, "batch": job.batch, "seq": job.seq,
          "remat": job.remat, "steps": job.steps,
          "loss": [m["loss"] for m in hist],
          "grad_norm": [m["grad_norm"] for m in hist],
          "lr": [m["lr"] for m in hist],
          "step_ms_each": [s * 1e3 for s in step_s],
          "gc_ms_each": [b[0] - a[0] for a, b in zip(host, host[1:])],
          "alloc_retries_each": [b[1] - a[1]
                                 for a, b in zip(host, host[1:])],
          "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
          "model_flops": flops, "model_flops_formula": flops_formula,
          "model_flops_share_bf16": flops / (step_ms / 1e3)
          / BF16_PEAK_FLOPS,
          "loss_0_over_ln_vocab": hist[0]["loss"] / math.log(cfg.vocab),
          "peak_allocated_bytes": peak, "card_memory_bytes": total,
          "bf16_param_elements_changed": changed,
          "profiled_steps": list(range(profiled_from, job.steps)),
          "profiled_ms": window_ms,
          "kernels_per_step": dev["kernels"],
          "device_busy_ms": busy_ms,
          "device_idle_share": idle if idle >= 0 else None,
          "device_busy_over_wall": idle < 0,
          "device_ms_per_step_by_group": dev["device_ms_by_group"],
          "top": dev["top"],
          "serve_kernel_launches": counts, "nvidia_smi": card,
          "seconds": time.time() - t0})


def phase_train_resume(torch, np):
    """``launch.train.train`` on :data:`RESUME_JOB` (gpt2-124m at full
    width) twice: through the resilient loop over a checkpoint store in a
    fresh directory, with one ``SimulatedDeviceLoss`` raised before step
    :data:`RESUME_FAULT_STEP` (as the scenario harness's device-loss plan
    raises it), and straight through without a fault or a store.  Requires
    one restart, the store's last step the job's, and final params and
    optimizer state bit-equal to the unfaulted run's, or, where the card's
    step is not bit-for-bit repeatable, within parity-train's bounds with
    the ops named that may make it so; and the faulted run's peak of
    allocated memory at most :data:`RESUME_PEAK_RATIO` times the clean
    run's (the restart drops the failed state and restores onto a template
    of shapes, so the card never holds two states)."""
    import tempfile

    from repro_torch.launch import train as launch
    from repro_torch.scenarios.faults import SimulatedDeviceLoss
    from repro_torch.checkpoint import CheckpointStore

    t0 = time.time()
    armed = [True]
    every = RESUME_JOB["ckpt_every"]
    restore_at = RESUME_FAULT_STEP // every * every

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        marker = Path(d) / f"step_{restore_at:08d}" / "_COMMITTED"

        def crash(step):
            # the fault strikes once the last checkpoint before it has
            # committed (the store writes it on a thread), so the restart
            # restores it
            if step == RESUME_FAULT_STEP and armed[0]:
                deadline = time.time() + COMMIT_WAIT_S
                while not marker.exists() and time.time() < deadline:
                    time.sleep(0.05)
                armed[0] = False
                raise SimulatedDeviceLoss(
                    f"injected device loss before step {step}")

        faulted = launch.train(launch.TrainJob(**RESUME_JOB, ckpt_dir=d),
                               hook=crash)
        last = CheckpointStore(d).latest_step()
    peak_faulted = torch.cuda.max_memory_allocated()
    # off the card, so that the clean run's peak is its own
    faulted["state"] = tree_to(faulted["state"], "cpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    clean = launch.train(launch.TrainJob(**RESUME_JOB))
    t2 = time.time()
    peak_clean = torch.cuda.max_memory_allocated()
    require(peak_faulted <= RESUME_PEAK_RATIO * peak_clean,
            f"train-resume: the faulted run's peak {peak_faulted} B is over "
            f"{RESUME_PEAK_RATIO} x the clean run's {peak_clean} B")
    require(faulted["restarts"] == 1 and not armed[0],
            f"train-resume restarted {faulted['restarts']} times")
    require(last == RESUME_JOB["steps"], f"train-resume: the store's last "
            f"step is {last}")
    logged = [m["step"] for m in faulted["history"]]
    steps = RESUME_JOB["steps"]
    require(logged == list(range(RESUME_FAULT_STEP))
            + list(range(restore_at, steps)),
            f"train-resume: the faulted run logged steps {logged}, not a "
            f"replay from the step-{restore_at} checkpoint")
    state_f, state_c = faulted["state"], clean["state"]
    worst, differ = _tree_diff(torch, state_f, state_c)
    bit_equal = differ == 0
    ops = []
    if not bit_equal:
        batch = _train_batch(torch, np, clean["cfg"], RESUME_JOB["seq"],
                             RESUME_JOB["batch"])
        _, census = _op_census(torch, lambda: _grads(
            clean["cfg"], state_c["params"], batch))
        ops = [op for op in census if op in NONDETERMINISTIC_CUDA_OPS]
        require(_trees_close(torch, state_f["params"], state_c["params"],
                             **TRAIN_TOL) and
                _trees_close(torch, state_f["opt"]["master"],
                             state_c["opt"]["master"], **TRAIN_TOL),
                f"train-resume: faulted and clean runs part by {worst} "
                f"in {differ} leaves (ops {ops})")
    emit({"phase": "train-resume", "arch": faulted["cfg"].name,
          "batch": RESUME_JOB["batch"], "seq": RESUME_JOB["seq"],
          "steps": RESUME_JOB["steps"],
          "ckpt_every": RESUME_JOB["ckpt_every"],
          "fault_step": RESUME_FAULT_STEP, "restored_step": restore_at,
          "restarts": faulted["restarts"], "logged_steps": logged,
          "last_checkpoint": last, "bit_equal": bit_equal,
          "max_abs_diff": worst, "leaves_differing": differ,
          "nondeterministic_ops": ops,
          "peak_allocated_faulted": peak_faulted,
          "peak_allocated_clean": peak_clean,
          "loss_faulted": [m["loss"] for m in faulted["history"]],
          "loss_clean": [m["loss"] for m in clean["history"]],
          "faulted_s": t1 - t0, "clean_s": t2 - t1,
          "seconds": time.time() - t0})
    del faulted, clean, state_f, state_c
    torch.cuda.empty_cache()


def _train_batch(torch, np, cfg, seq, batch, device="cuda"):
    """A batch laid out as the pipeline's (Zipf tokens, next-token labels,
    the VLM's unit-Gaussian image embeddings before the text, the
    encoder-decoder's unit-Gaussian frames), as tensors
    on ``device``, drawn from a fixed numpy seed: the pipeline seeds with
    a string's hash, which Python randomizes per process, so every run
    would hold the card to another batch, and a batch that puts a
    router at a near tie (one run's jamba loss parted by 9.96e-6 of its
    value) shows in some runs and not in others."""
    rng = np.random.default_rng(PARITY_TRAIN_SEED)
    n_img = cfg.n_img_tokens if cfg.family == "vlm" else 0
    z = rng.zipf(1.2, size=(batch, seq - n_img + 1)).astype(np.int64)
    tokens = torch.from_numpy(((z - 1) % cfg.vocab).astype(np.int32))
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if n_img:
        out["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, n_img, cfg.d_model), dtype=np.float32))
    if cfg.is_encoder_decoder:
        out["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (batch, max(seq // 4, 8), cfg.d_model), dtype=np.float32))
    return {k: v.contiguous().to(device) for k, v in out.items()}


def _grads(cfg, params, batch):
    """(gradients, metrics) of one step's loss, without remat."""
    from repro_torch.train import steps as steps_mod

    return steps_mod.loss_and_grads(params, cfg, batch,
                                    steps_mod.RunConfig(remat="none"))


def phase_parity_train(torch, np):
    """Each of the eleven archs' smoke configs (f32; TF32 is off), the
    encoder-decoder included:
    from the same weights (the port's seeded init, drawn on the CPU) and
    batch (:func:`_train_batch`, from a fixed seed), one train step on the
    card against the CPU's: the loss at rtol 1e-5; every gradient, the
    params after the step and the moments ``m`` and ``v`` at
    :data:`TRAIN_TOL` (the moments' atol carried through their update).
    At the first step's lr (3e-6 in the warm-up) an update that does
    nothing stays under that atol, so the card's update is also held,
    within :data:`UPDATE_TOL_SHARE` of the lr, to AdamW replayed on the
    CPU from the card's gradients.  Printed for each arch: the worst ratio
    of a difference to its bound (1 or less passes), whether the card's
    gradients computed twice are bit-equal, and which aten ops of the step
    may accumulate with atomics (:data:`NONDETERMINISTIC_CUDA_OPS`)."""
    import repro_torch.configs as configs
    from repro_torch.optim import adamw
    from repro_torch.train import steps as steps_mod

    t0 = time.time()
    rows = {}
    for arch in configs.ALL_ARCHS:
        cfg = configs.get_smoke_config(arch)
        cpu_p = steps_mod.init_model(cfg, seed=0, device="cpu")
        card_p = tree_to(cpu_p, "cuda")
        b_cpu = _train_batch(torch, np, cfg, PARITY_TRAIN_SEQ,
                             PARITY_TRAIN_BATCH, device="cpu")
        b_card = {k: v.to("cuda") for k, v in b_cpu.items()}
        g_cpu, m_cpu = _grads(cfg, cpu_p, b_cpu)
        (g_card, m_card), census = _op_census(
            torch, lambda: _grads(cfg, card_p, b_card))
        g_again, _ = _grads(cfg, card_p, b_card)
        repeatable = _tree_diff(torch, g_card, g_again)[1] == 0
        run = steps_mod.RunConfig(remat="none")
        opt = run.opt
        step = steps_mod.make_train_step(cfg, run)
        p_cpu, o_cpu, s_cpu = step(cpu_p, adamw.init_opt_state(cpu_p, opt),
                                   b_cpu)
        p_card, o_card, s_card = step(card_p,
                                      adamw.init_opt_state(card_p, opt),
                                      b_card)
        lr = float(s_cpu["lr"])
        upd_card, _, _ = adamw.apply_update(
            card_p, g_card, adamw.init_opt_state(card_p, opt), opt)
        upd_cpu, _, _ = adamw.apply_update(
            cpu_p, tree_to(g_card, "cpu"), adamw.init_opt_state(cpu_p, opt),
            opt)
        upd_diff, upd_largest = _update_diff(torch, upd_card, card_p,
                                             upd_cpu, cpu_p)
        loss = (float(m_card["loss"]), float(m_cpu["loss"]))
        tol = TRAIN_TOL
        m_tol = dict(rtol=tol["rtol"], atol=(1 - opt.b1) * tol["atol"])
        v_tol = dict(rtol=tol["rtol"], atol=(1 - opt.b2) ** 0.5 * tol["atol"])
        sqrt_v = [adamw.tree_map(torch.sqrt, o["v"]) for o in (o_card, o_cpu)]
        grad_worst = _worst(torch, g_card, g_cpu, **tol)
        param_worst = _worst(torch, p_card, p_cpu, **tol)
        m_worst = _worst(torch, o_card["m"], o_cpu["m"], **m_tol)
        v_worst = _worst(torch, *sqrt_v, **v_tol)
        row = {"loss_card": loss[0], "loss_cpu": loss[1], "tolerance": tol,
               "grad_max_abs_diff": _tree_diff(torch, g_card, g_cpu)[0],
               "grad_worst_ratio": grad_worst,
               "param_max_abs_diff": _tree_diff(torch, p_card, p_cpu)[0],
               "param_worst_ratio": param_worst,
               "m_worst_ratio": m_worst, "sqrt_v_worst_ratio": v_worst,
               "lr": lr, "update_max_abs_diff": upd_diff,
               "update_largest": upd_largest}
        require(abs(loss[0] - loss[1]) <= TRAIN_LOSS_RTOL * abs(loss[1]),
                f"parity-train {arch}: loss {loss[0]} on the card, "
                f"{loss[1]} on the CPU")
        for what, worst in (("gradients", grad_worst),
                            ("params after the step", param_worst),
                            ("m", m_worst), ("sqrt(v)", v_worst)):
            require(worst[0] <= 1.0, f"parity-train {arch}: {what} part "
                    f"past their bound: {row}")
        require(float(s_card["lr"]) == lr and int(o_card["step"]) == int(
            o_cpu["step"]) == 1, f"parity-train {arch}: lr "
            f"{float(s_card['lr'])} against {lr}, steps {o_card['step']} "
            f"and {o_cpu['step']}")
        require(upd_diff <= UPDATE_TOL_SHARE * lr
                and upd_largest >= UPDATE_MIN_SHARE * lr,
                f"parity-train {arch}: the card's update parts from the "
                f"CPU's replay of it by {upd_diff} (lr {lr}, the replay's "
                f"largest move {upd_largest})")
        rows[arch] = {**row, "grads_repeatable": repeatable,
                      "atomic_ops": [op for op in census
                                     if op in NONDETERMINISTIC_CUDA_OPS]}
    emit({"phase": "parity-train", "seq": PARITY_TRAIN_SEQ,
          "batch": PARITY_TRAIN_BATCH, "archs": rows,
          "seconds": time.time() - t0})


# -- whisper: the encoder-decoder ---------------------------------------------


def _mesh_batches(cfg, seq, batch, steps):
    """``steps`` global batches of the pipeline (numpy), drawn here."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline

    shape = ShapeConfig("train_mesh", seq, batch, "train")
    return [pipeline.global_batch(cfg, shape, pipeline.DataConfig(), s)
            for s in range(steps)]


def phase_train_mesh(torch, np, card):
    """The train step on (data, model) meshes of ranks sharing the card
    over gloo, their flat gradient and parameter buffers read through
    CUDA IPC, in the spawns of 2x2 ranks of :data:`TRAIN_MESH_SPAWNS`
    (``repro_torch.train.mesh_check``, each shape a mesh of a spawn's
    first ranks).

    ``parity-train-mesh`` (f32), a line a model of
    :data:`TRAIN_MESH_MODELS`, on 1x1, 2x1, 1x2 and 2x2 (each model's
    one-rank card step, no mesh, runs first on rank 0 from the same
    seeded init and batches): every rank's shards of params, ``m`` and
    ``v`` within :data:`TRAIN_TOL` of the one-rank step's same shards
    (read in place from rank 0), and each step's loss, grad norm and aux
    within its rtol; ZeRO off bit-equal to ZeRO on (every rank's digest
    of its shards) where :data:`TRAIN_MESH_ZERO_OFF` runs it; deepseek's
    dropped assignments above 0 and the same on every shape.

    ``train-mesh`` (bf16, :data:`TRAIN_MESH_BF16`): the trainer for
    qwen3-1.7b with ``--layers 4``, one step on one device through its
    entry point ``launch.train.train``, then the steps on 2x2 (ZeRO on)
    through ``launch.train.train_on``, what ``train`` runs on each rank
    it spawns (each rank drawing the seeded init a block at a time): a
    step's ms on the host clock to its metrics on the host (the median
    after the first) and tokens/s, rank 0's peak allocated bytes while it
    built its state (below the one-device run's) and over the steps, its
    optimizer state's bytes with ZeRO and without, its collectives'
    calls, bytes and host-staged bytes a step, the logits' all-gather
    over ``model`` a step (its bytes from this run's shapes), and the
    first loss within :data:`TRAIN_MESH_LOSS_ULPS` bf16 ulps of the
    one-device step's."""
    import repro_torch.configs as configs
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as layers_mod
    from repro_torch.scenarios.runner import bf16_ulp
    from repro_torch.train import mesh_check
    from repro_torch.train import steps as steps_mod

    t0 = time.time()
    # the ranks need most of the card: whatever earlier phases left in
    # this process (reference cycles included) goes first
    gc.collect()
    torch.cuda.empty_cache()
    parent_bytes = torch.cuda.memory_allocated()
    bf = TRAIN_MESH_BF16
    job = launch_train.TrainJob(
        arch="qwen3-1.7b", smoke=False, layers=bf["layers"],
        steps=bf["steps"], batch=bf["batch"], seq=bf["seq"], remat="none",
        log_every=1, device="cuda", zero=True)
    data_cfg = pipeline.DataConfig(seed=job.seed)
    t_one = time.time()
    one = launch_train.train(dataclasses.replace(job, steps=1),
                             data_cfg=data_cfg, keep_state=False)
    t_one = time.time() - t_one
    gc.collect()
    torch.cuda.empty_cache()
    run = steps_mod.RunConfig(remat="none")
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    # the ranks draw this process's batches, as ``train`` has them do
    jobs = {"train-mesh": {
        "name": "train-mesh", "kind": "train", "mesh": bf["shape"],
        "job": dataclasses.replace(job, mesh=bf["shape"]),
        "data_cfg": pipeline.with_role_hashes(data_cfg),
        "keep_state": False}}
    cfgs = {}
    for arch, layers in TRAIN_MESH_MODELS:
        cfg = dataclasses.replace(configs.get_config(arch), **f32)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cfgs[arch] = cfg
        jobs[arch] = {
            "name": arch, "kind": "steps", "cfg": cfg, "run": run,
            "batches": _mesh_batches(cfg, TRAIN_MESH_SEQ, TRAIN_MESH_BATCH,
                                     TRAIN_MESH_STEPS),
            "seed": 0, "shapes": TRAIN_MESH_SHAPES, "zeros": (True, False),
            "zero_shapes": TRAIN_MESH_ZERO_OFF[arch], "one_rank": True,
            "tol": TRAIN_TOL}
    out, spawn_s = {}, {}
    for names in TRAIN_MESH_SPAWNS:
        t_spawn = time.time()
        out.update(mesh_mod.spawn(
            mesh_check.run_jobs, 2, 2, [jobs[n] for n in names],
            device="cuda", build=False, timeout=TRAIN_MESH_TIMEOUT))
        spawn_s["+".join(names)] = time.time() - t_spawn
    del jobs
    for arch, _ in TRAIN_MESH_MODELS:
        res = out[arch]
        want = res["one_rank"]
        row = {}
        for shape in TRAIN_MESH_SHAPES:
            r = res[(shape, True)]
            for h, w in zip(r["history"], want):
                for key in ("loss", "grad_norm", "moe_aux"):
                    require(abs(h[key] - w[key]) <= TRAIN_TOL["rtol"]
                            * abs(w[key]) + 1e-7,
                            f"parity-train-mesh {arch} {shape}: {key} "
                            f"{h[key]} against {w[key]}")
            require(r["within_tol"], f"parity-train-mesh {arch} {shape}: "
                    f"the state parts from the one-rank step's: {r}")
            row[shape] = {k: v for k, v in r.items()
                          if k.startswith("max_abs_err") or k in (
                              "dropped", "opt_bytes", "ms", "counters")}
            row[shape]["loss"] = [h["loss"] for h in r["history"]]
            if (shape, False) in res:
                require(res[(shape, "zero_bit_equal")],
                        f"parity-train-mesh {arch} {shape}: ZeRO off "
                        f"parts from ZeRO on")
                row[shape]["zero_off_bit_equal"] = True
        drops = {shape: row[shape]["dropped"] for shape in row}
        if cfgs[arch].moe is not None:
            require(min(drops.values()) > 0
                    and len(set(drops.values())) == 1,
                    f"parity-train-mesh {arch}: dropped {drops}")
        emit({"phase": "parity-train-mesh", "model": arch,
              "layers": cfgs[arch].n_layers, "dtype": "float32",
              "steps": TRAIN_MESH_STEPS, "batch": TRAIN_MESH_BATCH,
              "seq": TRAIN_MESH_SEQ, "tolerance": TRAIN_TOL,
              "one_rank_loss": [h["loss"] for h in want],
              "one_rank_s": res["one_rank_s"], "shapes": row,
              "zero_off_shapes": list(TRAIN_MESH_ZERO_OFF[arch]),
              "job_seconds": res["seconds"]})

    res = out["train-mesh"]
    cfg = launch_train.job_configs(job)[0]
    hist = res["history"]
    steps_n = len(hist)
    require(steps_n == bf["steps"], f"train-mesh: {steps_n} steps logged")
    step_ms = statistics.median(res["step_ms"][1:])
    tokens = bf["batch"] * bf["seq"]
    loss, want = hist[0]["loss"], one["history"][0]["loss"]
    ulp = float(bf16_ulp(torch.tensor([want]))[0])
    require(abs(loss - want) <= TRAIN_MESH_LOSS_ULPS * ulp,
            f"train-mesh: first loss {loss} against the one-device step's "
            f"{want} (bf16 ulp {ulp})")
    mem, one_mem = res["memory"], one["memory"]
    require(mem["init_peak_bytes"] < one_mem["init_peak_bytes"],
            f"train-mesh: rank 0 peaked at {mem['init_peak_bytes']} bytes "
            f"building its state, the one-device run at "
            f"{one_mem['init_peak_bytes']}")
    c = res["collectives"]
    d, m = mesh_mod.parse_mesh(bf["shape"])
    tp = layers_mod.MeshContext(mesh_mod.MeshShape(d, m), cfg,
                                bf["batch"] // d, train=True)
    # the logits (B/D, S, V) fp32 a data rank, gathered over ``model``
    # once a step where the rules split the vocab: each rank puts in its
    # V/M columns and receives all M ranks'; gloo stages both via the host
    logits_in = (bf["batch"] // d * bf["seq"] * cfg.vocab_padded // m * 4
                 if tp.vocab_split else 0)
    emit({"phase": "train-mesh", "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": cfg.compute_dtype, "mesh": bf["shape"],
          "entry": "launch.train.train (one device), "
                   "launch.train.train_on (each rank)",
          "backend": "gloo, flat buffers over CUDA IPC",
          "tokens_per_step": tokens, "step_ms": step_ms,
          "step_ms_all": res["step_ms"],
          "tokens_per_s": tokens / (step_ms / 1e3),
          "init_peak_allocated_bytes_rank0": mem["init_peak_bytes"],
          "step_peak_allocated_bytes_rank0": mem["step_peak_bytes"],
          "one_device_init_peak_bytes": one_mem["init_peak_bytes"],
          "one_device_step_peak_bytes": one_mem["step_peak_bytes"],
          "opt_state_bytes_rank0_zero": mem["opt_state_bytes"],
          "opt_state_bytes_rank0_without_zero":
              mem["opt_state_bytes_without_zero"],
          "collective_calls_per_step": c["calls"] / steps_n,
          "collective_bytes_per_step": c["bytes"] / steps_n,
          "host_staged_bytes_per_step": c["host_bytes"] / steps_n,
          "logits_gather_bytes_per_step": {
              "put_in": logits_in, "gathered": m * logits_in,
              "host_staged": (1 + m) * logits_in},
          "loss": [h["loss"] for h in hist], "one_device_first_loss": want,
          "one_device_step_ms": one["step_ms"][0], "one_device_s": t_one,
          "nvidia_smi": card, "parent_allocated_bytes": parent_bytes,
          "spawn_s_by_spawn": spawn_s,
          "seconds_both_phases": time.time() - t0})


def whisper_decode_timing(torch, np):
    """Kernel 2.3 at whisper-large-v3's decode shapes (bf16, 20 KV heads,
    G 1, D 64, 8 slots): the cross-attention over 1500 encoder rows, every
    one valid (S not a power of two, nor a multiple of the 256-row
    split), and the self-attention over a 448-row cache at the decode's
    middle length: each against its plain version (the cross shape also
    in fp32), then kernel, plain and library ms beside the least time for
    the live rows.  The library yardstick is one SDPA call (with a length
    mask for the self-attention).  Returns {"cross": row, "self": row}."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref as fd_ref

    cfg_heads = (20, 1, 64)
    KV, G, D = cfg_heads
    rows = {}
    for name, S, length in (
            ("cross", WHISPER_FRAMES, WHISPER_FRAMES),
            ("self", WHISPER_MAX_LEN, WHISPER_PROMPT + WHISPER_NEW // 2)):
        gen = torch.Generator(device="cuda").manual_seed(83)
        kw = dict(device="cuda", generator=gen)
        q = torch.randn((WHISPER_B, KV, G, D), **kw).to(torch.bfloat16)
        k, v = (torch.randn((WHISPER_B, S, KV, D), **kw).to(torch.bfloat16)
                for _ in range(2))
        valid = np.full(WHISPER_B, length)
        vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
        args = (q, k, v, vl)

        def kernel():
            return fd.flash_decode(*args, block_s=S)

        out = kernel()
        err, ok = decode_close(torch, out, fd.flash_decode_plain(
            *args, block_s=S))
        require(ok, f"flash_decode != plain at whisper's {name} shape: "
                    f"{err}")
        args32 = [x.float() if x.is_floating_point() else x for x in args]
        err32, ok32 = decode_close(
            torch, fd.flash_decode(*args32, block_s=S),
            fd.flash_decode_plain(*args32, block_s=S))
        require(ok32, f"flash_decode != plain at whisper's {name} shape in "
                      f"fp32: {err32}")
        del args32
        qh = q.reshape(WHISPER_B, KV * G, 1, D)
        kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
        mask = None if length == S else (
            torch.arange(S, device="cuda")[None, :]
            < vl[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        lib_err = (library().reshape(out.shape).float()
                   - out.float()).abs().max().item()
        require(lib_err <= 2 * TOLERANCE["bfloat16"],
                f"SDPA yardstick disagrees at whisper's {name} shape: "
                f"{lib_err}")
        bound_ms, bound_by = bound(fd_ref.decode_work_terms(q, k, valid),
                                   "bfloat16")
        row = {"max_abs_err": err, "fp32_max_abs_err": err32,
               "ms": device_ms(torch, kernel, reps=50),
               "plain_ms": device_ms(torch, lambda: fd.flash_decode_plain(
                   *args, block_s=S), reps=20),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": device_ms(torch, library, reps=50),
               "host_us": host_us(torch, kernel)}
        if name == "cross":  # the tuner's split_rows space at this shape
            row["ms_by_split_rows"] = {
                split: device_ms(torch, lambda split=split: fd.flash_decode(
                    *args, block_s=S, split_rows=split), reps=50)
                for split in WHISPER_SPLITS}
        rows[name] = row
        emit({"phase": "timing-whisper", "kernel": "flash_decode",
              "attention": name, "B": WHISPER_B, "S": S, "KV": KV, "G": G,
              "D": D, "valid_len": length, "dtype": "bfloat16",
              "tolerance": CLOSE_TOL, **row})
    return rows


def _whisper_greedy(torch, cfg, params, frames, prompt, steps, max_len,
                    sync=False, hook=None):
    """Prefill ``prompt`` after ``frames`` into a cache of ``max_len``
    rows, then ``steps`` greedy decode steps, through the step functions:
    (the stream (B, 1 + steps) int32, the logits of the prefill and of
    every step (B, 1 + steps, vocab) fp32, the cache, the prefill's ms
    and each step's ms, timed with the card synchronized when ``sync``).
    ``hook`` is called with each decode step's index before it runs, and
    with ``steps`` after the last."""
    from repro_torch.train import steps as steps_mod

    prefill = steps_mod.make_prefill_step(cfg)
    decode = steps_mod.make_decode_step(cfg)
    if sync:
        torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(params, enc_frames=frames, tokens=prompt,
                            max_len=max_len)
    outs = [logits[:, -1, :cfg.vocab]]
    tokens = [outs[-1].argmax(-1).to(torch.int32)]
    if sync:
        torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    prefill_ms = (stamps[0] - t) * 1e3
    for i in range(steps):
        if hook is not None:
            hook(i)
        logits, cache = decode(params, tokens=tokens[-1][:, None],
                               cache=cache)
        outs.append(logits[:, -1, :cfg.vocab])
        tokens.append(outs[-1].argmax(-1).to(torch.int32))
        if sync:
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    if hook is not None:
        hook(steps)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return (torch.stack(tokens, 1), torch.stack(outs, 1), cache, prefill_ms,
            step_ms)


def _device_groups(prof, calls: int, top: int = 5) -> dict:
    """A profile's device time for each of ``calls`` calls: busy ms,
    kernels, ms by :data:`TRAIN_GROUPS`, and its ``top`` kernels' ms and
    launches."""
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    groups = {}
    for e in rows:
        group = next((g for g, words in TRAIN_GROUPS
                      if any(w in e.key.lower() for w in words)), "other")
        groups[group] = groups.get(group, 0.0) \
            + e.self_device_time_total / 1e3 / calls
    first = sorted(rows, key=lambda e: -e.self_device_time_total)[:top]
    return {"device_busy_ms": sum(e.self_device_time_total
                                  for e in rows) / 1e3 / calls,
            "kernels": sum(e.count for e in rows) / calls,
            "device_ms_by_group": groups,
            "top": [{"kernel": e.key[:80],
                     "device_ms": e.self_device_time_total / 1e3 / calls,
                     "calls": e.count / calls} for e in first]}


def phase_whisper_decode(torch, np, kernel):
    """whisper-large-v3 at full width (bf16, 32 + 32 layers, drawn on the
    card) through ``steps.make_prefill_step`` and ``make_decode_step``:
    8 slots, each over its own 1500 post-conv frames (Whisper's 30-s
    window), a 4-token prompt prefilled into a cache of 448 rows, then
    127 greedy decode steps (128 tokens a slot).  Requires finite logits,
    kernel 2.3 launched exactly 2 x 32 times a decode step (each decoder
    layer's self-attention and cross-attention) and no other serve
    kernel, and, against the teacher-forced ``forward`` over the stream's
    own first 16 tokens, the step logits within
    :data:`WHISPER_LOGITS_SHARE` of its largest logit and the tokens its
    argmax wherever its top-2 gap is over twice their largest difference.
    The logits bound and the argmax check are a sanity bound on the
    bf16 path as a whole (how many positions the argmax check covered is
    printed); the kernel itself is held against its plain version in
    ``timing-whisper``.  Prints the prefill's ms, the decode step's median
    ms, tokens/s, the launches, the cross K/V's bytes, and whether a
    second run, stopped after the profiled steps, gives the same streams
    that far, with a profile of its prefill and of 8 of its decode steps
    (kernels, device time by group, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.configs as configs
    from repro_torch.models import whisper

    t0 = time.time()
    cfg = configs.get_config("whisper-large-v3")
    t_draw = time.time()
    params = whisper.init_whisper(cfg, seed=0, device="cuda",
                                  draw_device="cuda")
    torch.cuda.synchronize()
    draw_s = time.time() - t_draw
    gen = torch.Generator(device="cuda").manual_seed(5)
    frames = torch.randn((WHISPER_B, WHISPER_FRAMES, cfg.d_model),
                         device="cuda", generator=gen).to(torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (WHISPER_B, WHISPER_PROMPT)).astype(np.int32)).cuda()
    steps = WHISPER_NEW - 1
    n_dec = whisper.n_dec_layers(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel)
    stream, logits, cache, prefill_ms, step_ms = _whisper_greedy(
        torch, cfg, params, frames, prompt, steps, WHISPER_MAX_LEN,
        sync=True)
    counts = read_counts(kernel)
    peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(logits).all()),
            "whisper-decode: a logit is not finite")
    require(counts["flash_decode"] == 2 * n_dec * steps
            and not any(counts[k] for k in SERVE_KERNELS
                        if k != "flash_decode"),
            f"whisper-decode: {counts} for {steps} steps of {n_dec} "
            f"decoder layers")
    require(cache["pos"] == WHISPER_PROMPT + steps,
            f"whisper-decode: cache at {cache['pos']}")
    cross_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in ("cross_k", "cross_v"))
    self_bytes = sum(cache[k].numel() * cache[k].element_size()
                     for k in ("k", "v"))
    del cache
    # a second run up to the last profiled step: its prefill (with the
    # first token's argmax) profiled, then its decode steps from
    # WHISPER_PROFILED_FROM
    again_steps = WHISPER_PROFILED_FROM + WHISPER_PROFILED
    pre = profile(activities=[ProfilerActivity.CUDA])
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = []

    def hook(i):
        if i in (0, WHISPER_PROFILED_FROM, again_steps):
            torch.cuda.synchronize()
        if i == 0:
            pre.stop()
        if i == WHISPER_PROFILED_FROM:
            prof.start()
            window.append(time.perf_counter())
        elif i == again_steps:
            window.append(time.perf_counter())
            prof.stop()

    pre.start()
    again = _whisper_greedy(torch, cfg, params, frames, prompt, again_steps,
                            WHISPER_MAX_LEN, hook=hook)[0]
    step_prof = _device_groups(prof, WHISPER_PROFILED)
    step_prof["wall_ms"] = (window[1] - window[0]) * 1e3 / WHISPER_PROFILED
    step_prof["device_idle_share"] = \
        1.0 - step_prof["device_busy_ms"] / step_prof["wall_ms"]
    prefill_prof = _device_groups(pre, 1)
    # the stream's first tokens against the teacher-forced forward on the
    # same tokens: its logits, and its argmax away from near ties
    with torch.no_grad():
        full = torch.cat([prompt, stream[:, :WHISPER_CHECKED - 1]], 1)
        flogits, _ = whisper.forward(params, cfg, frames, full)
    top = flogits[:, WHISPER_PROMPT - 1:, :cfg.vocab].float()
    diff = (top - logits[:, :WHISPER_CHECKED]).abs().max().item()
    scale = top.abs().max().item()
    require(diff <= WHISPER_LOGITS_SHARE * scale,
            f"whisper-decode: the step logits part from the forward's by "
            f"{diff}, over {WHISPER_LOGITS_SHARE} of its largest {scale}")
    want = top.argmax(-1).to(torch.int32)
    gap = top.topk(2, dim=-1).values
    gap = gap[..., 0] - gap[..., 1]
    wide = gap > 2 * diff
    differ = (want != stream[:, :WHISPER_CHECKED])
    require(not bool((differ & wide).any()),
            f"whisper-decode: the stream parts from the forward's argmax "
            f"where its top-2 gap is over {2 * diff}: "
            f"{differ.nonzero().tolist()}")
    del flogits, params, logits
    torch.cuda.empty_cache()
    decode_s = sum(step_ms) / 1e3
    emit({"phase": "whisper-decode", "arch": cfg.name,
          "layers": [cfg.enc_layers, n_dec], "d_model": cfg.d_model,
          "dtype": cfg.param_dtype, "slots": WHISPER_B,
          "frames": WHISPER_FRAMES, "prompt": WHISPER_PROMPT,
          "decode_steps": steps, "max_len": WHISPER_MAX_LEN,
          "draw_s": draw_s, "prefill_ms": prefill_ms,
          "decode_step_ms": statistics.median(step_ms[1:]),
          "decode_step_ms_first": step_ms[0],
          "tokens_per_s": WHISPER_B * steps / decode_s,
          "flash_decode_launches": counts["flash_decode"],
          "flash_decode_launches_per_step": counts["flash_decode"] / steps,
          "serve_kernel_launches": counts,
          "cross_kv_bytes": cross_bytes, "self_kv_bytes": self_bytes,
          "peak_allocated_bytes": peak,
          "streams_equal_twice": bool(torch.equal(
              stream[:, :again_steps + 1], again)),
          "streams_compared_tokens": again_steps + 1,
          "checked_tokens": WHISPER_CHECKED,
          "forward_logits_max_abs_diff": diff,
          "forward_logits_max_abs": scale,
          "forward_top2_gap_median": gap.median().item(),
          "forward_argmax_differs": int(differ.sum()),
          "forward_argmax_positions": differ.numel(),
          "forward_argmax_positions_checked": int(wide.sum()),
          "profiled_steps": [WHISPER_PROFILED_FROM,
                             WHISPER_PROFILED_FROM + WHISPER_PROFILED],
          "decode_step_profile": step_prof, "prefill_profile": prefill_prof,
          "seconds": time.time() - t0})
    return counts["flash_decode"]


def phase_parity_whisper(torch, np, kernel):
    """whisper-large-v3's smoke config (f32, TF32 off) on the card against
    the CPU from the same weights (the port's seeded init, drawn on the
    CPU): 3 slots over 24 frames (not a multiple of the kernel's tile), a
    4-token prompt prefilled into a cache of 20 rows, then
    :data:`WHISPER_PARITY_STEPS` greedy decode steps on each.  Requires
    the teacher-forced ``forward``'s, the prefill's and every step's
    logits at rtol 1e-4 and atol 1e-5, equal greedy streams, and kernel
    2.3 launched twice a decoder layer a step on the card."""
    import repro_torch.configs as configs
    from repro_torch.models import whisper

    t0 = time.time()
    cfg = configs.get_smoke_config("whisper-large-v3")
    cpu = whisper.init_whisper(cfg, seed=0, device="cpu")
    card = tree_to(cpu, "cuda")
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.standard_normal((3, 24, cfg.d_model),
                                                  dtype=np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 4))
                              .astype(np.int32))
    max_len = 4 + WHISPER_PARITY_STEPS
    reset_counts(kernel)
    got = _whisper_greedy(torch, cfg, card, frames.cuda(), prompt.cuda(),
                          WHISPER_PARITY_STEPS, max_len)
    counts = read_counts(kernel)
    want = _whisper_greedy(torch, cfg, cpu, frames, prompt,
                           WHISPER_PARITY_STEPS, max_len)
    n_dec = whisper.n_dec_layers(cfg)
    require(counts["flash_decode"] == 2 * n_dec * WHISPER_PARITY_STEPS,
            f"parity-whisper: {counts} for {WHISPER_PARITY_STEPS} steps of "
            f"{n_dec} decoder layers")
    streams_equal = torch.equal(got[0].cpu(), want[0])
    require(streams_equal, f"parity-whisper: greedy streams differ: "
            f"{got[0].cpu().tolist()} against {want[0].tolist()}")
    tol = dict(rtol=1e-4, atol=1e-5)
    step_close = torch.allclose(got[1].cpu(), want[1], **tol)
    step_err = (got[1].cpu() - want[1]).abs().max().item()
    with torch.no_grad():
        full = torch.cat([prompt, want[0][:, :-1]], 1)
        f_card, _ = whisper.forward(card, cfg, frames.cuda(), full.cuda())
        f_cpu, _ = whisper.forward(cpu, cfg, frames, full)
    fwd_err = (f_card.cpu() - f_cpu).abs().max().item()
    require(step_close and torch.allclose(f_card.cpu(), f_cpu, **tol),
            f"parity-whisper: logits part, prefill and steps by {step_err}, "
            f"forward by {fwd_err}")
    emit({"phase": "parity-whisper", "arch": cfg.name, "slots": 3,
          "frames": 24, "prompt": 4, "decode_steps": WHISPER_PARITY_STEPS,
          "tolerance": tol, "step_logits_max_abs_diff": step_err,
          "forward_logits_max_abs_diff": fwd_err,
          "streams_equal": streams_equal,
          "flash_decode_launches": counts["flash_decode"],
          "seconds": time.time() - t0})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 1
    start_watchdog()
    sys.path.insert(0, str(SRC))
    import numpy as np

    import repro_torch
    import repro_torch.configs as configs
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import kernel, ref

    require(Path(repro_torch.__file__).resolve().is_relative_to(SRC),
            f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    resolve_device("cuda")  # also switches TF32 off
    card = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.time()
    built = build.build(force=True)
    emit({"phase": "build", "seconds": time.time() - t0, "libraries": {
        name: {"library": str(lib.relative_to(ROOT)),
               "seconds": build.SECONDS[name],
               "units": 1 + len(build.PARTS.get(name, ())),
               "ptxas": [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, (lib, log) in built.items()}})

    check_decode(torch, np, kernel, ref)
    decode_timing(torch, np, kernel, ref, "gpt2-124m", 16, 64 + 32, seed=2)
    decode_row = decode_timing(torch, np, kernel, ref, "qwen3-1.7b", 64,
                               512 + 32, seed=8)
    check_prefill(torch, np, kernel, ref)
    prefill_row = prefill_timing(torch, np, kernel, ref)
    check_quantized_decode(torch, np, kernel, ref)
    check_quantized_prefill(torch, np, kernel, ref)
    qdecode_row = quantized_decode_timing(torch, np, kernel, ref)
    qprefill_row = quantized_prefill_timing(torch, np, kernel, ref)
    commit_row = commit_timing(torch, np, kernel, ref, torch.bfloat16)
    qcommit_row = commit_timing(torch, np, kernel, ref, torch.int8)
    check_fused_commit(torch, np, kernel, ref)
    moe_prefill_row = prefill_timing(torch, np, kernel, ref,
                                     "deepseek-moe-16b")
    jamba_prefill_row = prefill_timing(torch, np, kernel, ref,
                                       "jamba-1.5-large-398b")
    spec_rows = {(arch, C): prefill_timing(torch, np, kernel, ref, arch, C,
                                           16, 96 - C, f"speculative C {C}")
                 for arch, C in (("gpt2-124m", 1), ("gpt2-124m", SPEC_K + 1),
                                 ("qwen3-1.7b", SPEC_K + 1))}
    fused_rows = {
        (arch, pool): fused_commit_timing(torch, np, kernel, ref, arch, nb,
                                          max_valid, seed, pool)
        for arch, nb, max_valid, seed, pool in (
            ("qwen3-1.7b", 64, 512 + 32, 8, torch.bfloat16),
            ("qwen3-1.7b", 64, 512 + 32, 8, torch.int8),
            ("gpt2-124m", 16, 64 + 32, 2, torch.bfloat16),
            ("deepseek-moe-16b", 64, 512 + 32, 8, torch.bfloat16),
            ("jamba-1.5-large-398b", 64, 512 + 32, 8, torch.bfloat16))}
    check_sharded_decode(torch, np, kernel, ref)
    sharded_row = sharded_decode_timing(torch, np, kernel, ref)
    jamba_sharded_row = sharded_decode_timing(torch, np, kernel, ref,
                                              "jamba-1.5-large-398b")

    check_hpc(torch, np)
    check_rx_gate(torch, np)
    check_flash_decode(torch, np)
    check_registry_workloads(torch)
    problems = hpc_problems(torch)
    hpc_rows = hpc_timing(torch, problems)
    rx_gates, rx_layers = rx_timing(torch)
    fd_rows = flash_decode_timing(torch, np)
    wave_rows = wave_decode_timing(torch, np)
    whisper_rows = whisper_decode_timing(torch, np)
    torch.cuda.empty_cache()
    hpc_counts, analysis_report, analysis_cells = phase_analysis(
        torch, np, problems)
    del problems
    phase_analysis_compiled(torch)
    suite_launches = phase_suite(torch, card)
    torch.cuda.empty_cache()
    phase_quickstart(torch)
    tuning_launches, tuning_rows = phase_tuning(torch, np)
    torch.cuda.empty_cache()

    engine, _, report = phase_serve(torch, SERVE_ARGV, "serve")
    phase_profile(torch, np, engine, "profile", 4, 64)
    # serve-spec's self-speculation and serve-sampled run on these weights
    gpt2_params = engine.params
    greedy = [r["tokens"] for r in report["requests"]]
    del engine
    engine, counts, _ = phase_serve(torch, CHUNKED_ARGV, "serve-chunked")
    phase_profile(torch, np, engine, "profile-chunked", 64, 256)
    chunked_params = engine.params  # the mesh ranks' shards come from it
    del engine
    torch.cuda.empty_cache()
    wave_launches = phase_serve_wave(
        torch, np, {"gpt2-124m": gpt2_params, "qwen3-1.7b": chunked_params},
        {"gpt2-124m": report})
    torch.cuda.empty_cache()
    shared_counts = phase_serve_shared(torch, np, chunked_params)
    torch.cuda.empty_cache()
    spec_lines = {
        "qwen3": phase_serve_spec(torch, SPEC_QWEN_ARGV, "serve-spec",
                                  chunked_params, spec_rows),
        "gpt2": phase_serve_spec(torch, SPEC_ARGV, "serve-spec",
                                 gpt2_params, spec_rows)}
    phase_serve_sampled(torch, np, gpt2_params, greedy)
    scenario_counts, scenario_results = phase_scenario(torch, np, {
        "gpt2-124m": (configs.get_config("gpt2-124m"), gpt2_params),
        "qwen3-1.7b": (configs.get_config("qwen3-1.7b"), chunked_params)})
    phase_parity_scenario(torch, np)
    del gpt2_params
    torch.cuda.empty_cache()
    phase_serve_smoke(torch)
    phase_perf_ledger(torch, card, scenario_results, analysis_report,
                      analysis_cells)
    del scenario_results
    phase_parity(torch, np)
    phase_parity_chunked(torch, np)
    phase_parity_spec(torch, np)
    phase_parity_int8(torch, np)
    phase_parity_wave(torch, np)
    torch.cuda.empty_cache()
    moe_counts = phase_serve_moe(torch, np)
    torch.cuda.empty_cache()
    phase_parity_moe(torch, np)
    torch.cuda.empty_cache()
    phase_serve_mla(torch, np)
    torch.cuda.empty_cache()
    phase_parity_mla(torch, np)
    torch.cuda.empty_cache()
    phase_serve_mamba2(torch, np)
    torch.cuda.empty_cache()
    phase_parity_mamba2(torch, np)
    torch.cuda.empty_cache()
    mesh_launches, mesh_commits = phase_serve_mesh(torch, chunked_params)
    del chunked_params
    int8_mesh_commits, jamba_mesh_launches = phase_parity_mesh(torch)
    # jamba last, with every earlier engine and weight freed
    torch.cuda.empty_cache()
    jamba_counts = phase_serve_jamba(torch, np)
    torch.cuda.empty_cache()
    phase_parity_jamba(torch, np)
    # the train stack last, on a card with nothing else held
    torch.cuda.empty_cache()
    phase_train(torch, np, kernel, card)
    phase_train_resume(torch, np)
    phase_parity_train(torch, np)
    torch.cuda.empty_cache()
    phase_train_mesh(torch, np, card)
    # the encoder-decoder, on a card with nothing else held
    torch.cuda.empty_cache()
    phase_train(torch, np, kernel, card, WHISPER_TRAIN_JOB, "whisper-train",
                whisper_model_flops, WHISPER_PROFILED_STEP)
    torch.cuda.empty_cache()
    whisper_launches = phase_whisper_decode(torch, np, kernel)
    phase_parity_whisper(torch, np, kernel)

    emit({"kernels": [
        {"name": "flash_decode_paged", "route": "cuda",
         "source": SOURCE_DIR + "flash_decode_paged.cuh",
         "replaces": f"{TPU_KERNELS}:256",
         "launches": counts["flash_decode_paged"],
         "scenario_launches": scenario_counts["flash_decode_paged"],
         "serve_moe_launches": moe_counts["flash_decode_paged"],
         "serve_jamba_launches": jamba_counts["flash_decode_paged"],
         "serve_spec_launches": {
             arch: line["launches"]["flash_decode_paged"]
             for arch, line in spec_lines.items()},
         **decode_row},
        {"name": "flash_prefill_paged", "route": "cuda",
         "source": SOURCE_DIR + "flash_prefill_paged.cu",
         "replaces": f"{TPU_KERNELS}:573,620",
         "launches": counts["flash_prefill_paged"],
         "scenario_launches": scenario_counts["flash_prefill_paged"],
         "serve_moe_launches": moe_counts["flash_prefill_paged"],
         "serve_jamba_launches": jamba_counts["flash_prefill_paged"],
         "deepseek-moe-16b": moe_prefill_row,
         "jamba-1.5-large-398b": jamba_prefill_row,
         "serve_spec_launches_by_width": {
             arch: line["prefill_launches_by_width"]
             for arch, line in spec_lines.items()},
         "speculative": {f"{arch} C {C}": row
                         for (arch, C), row in spec_rows.items()},
         "variants": tuning_entry(
             tuning_launches, tuning_rows, ["flash-prefill"],
             SOURCE_DIR + "flash_prefill_variants.cu"),
         **prefill_row},
        {"name": "flash_decode_paged_int8", "route": "cuda",
         "source": SOURCE_DIR + "flash_decode_paged.cuh",
         "replaces": f"{TPU_KERNELS}:256",
         "launches": shared_counts["flash_decode_paged"], **qdecode_row},
        {"name": "flash_prefill_paged_int8", "route": "cuda",
         "source": SOURCE_DIR + "flash_prefill_paged.cu",
         "replaces": f"{TPU_KERNELS}:573,620",
         "launches": shared_counts["flash_prefill_paged"], **qprefill_row},
        {"name": "flash_decode_paged_sharded", "route": "cuda",
         "source": SOURCE_DIR + "flash_decode_paged.cuh",
         "replaces": f"{TPU_KERNELS}:264",
         "launches": mesh_launches,
         "parity_mesh_jamba_launches": jamba_mesh_launches,
         "shape": "qwen3-1.7b serve, slice (0, 2) of 8 KV heads, bf16",
         "jamba-1.5-large-398b": jamba_sharded_row, **sharded_row},
        {"name": "flash_decode_paged_commit", "route": "cuda",
         "source": SOURCE_DIR + "flash_decode_paged.cuh",
         "replaces": f"{TPU_KERNELS}:256,573",
         "launches": counts["decode_commits"],
         "scenario_launches": scenario_counts["decode_commits"],
         "serve_moe_launches": moe_counts["decode_commits"],
         "serve_jamba_launches": jamba_counts["decode_commits"],
         "shape": "qwen3-1.7b serve, bf16",
         "gpt2": fused_rows["gpt2-124m", torch.bfloat16],
         "deepseek-moe-16b": fused_rows["deepseek-moe-16b", torch.bfloat16],
         "jamba-1.5-large-398b": fused_rows["jamba-1.5-large-398b",
                                            torch.bfloat16],
         **fused_rows["qwen3-1.7b", torch.bfloat16]},
        {"name": "flash_decode_paged_commit_int8", "route": "cuda",
         "source": SOURCE_DIR + "flash_decode_paged.cuh",
         "replaces": f"{TPU_KERNELS}:256,573",
         "launches": shared_counts["decode_commits"],
         "shape": "qwen3-1.7b serve, int8 pools",
         **fused_rows["qwen3-1.7b", torch.int8]},
        {"name": "commit_paged", "route": "cuda",
         "source": SOURCE_DIR + "flash_prefill_paged.cu",
         "replaces": f"{TPU_KERNELS}:573",
         "launches": mesh_commits, "path": "serve-mesh 2x2 (other rank's "
         "rows)", "unsharded_serve_launches": counts["commit_paged"],
         **commit_row},
        {"name": "commit_paged_int8", "route": "cuda",
         "source": SOURCE_DIR + "flash_prefill_paged.cu",
         "replaces": f"{TPU_KERNELS}:573",
         "launches": int8_mesh_commits, "path": "parity-mesh int8 2x1, "
         "2x2 (other rank's rows)",
         "unsharded_serve_launches": shared_counts["commit_paged"],
         **qcommit_row},
        {"name": "stream", "op": "triad", "route": "cuda",
         "source": HPC_SOURCES + "stream/csrc/stream.cu",
         "replaces": f"{TPU_HPC}stream/kernel.py:38",
         "launches": sum(hpc_counts[f"stream_{op}"] for op in STREAM_OPS),
         "variants": tuning_entry(
             tuning_launches, tuning_rows,
             [f"stream-{op}" for op in STREAM_OPS],
             HPC_SOURCES + "stream/csrc/stream_variants.cu"),
         **hpc_rows["stream_triad"]},
        {"name": "gemm", "route": "cuda",
         "source": HPC_SOURCES + "gemm/csrc/gemm_simt.cu",
         "replaces": f"{TPU_HPC}gemm/kernel.py:56",
         "launches": hpc_counts["gemm_simt"],
         "variants": tuning_entry(
             tuning_launches, tuning_rows, ["gemm"],
             HPC_SOURCES + "gemm/csrc/gemm_simt_variants.cu", "simt",
             "fp32"),
         **hpc_rows["gemm"]},
        {"name": "gemm_bf16", "route": "cuda",
         "source": HPC_SOURCES + "gemm/csrc/gemm_wgmma.cu",
         "replaces": f"{TPU_HPC}gemm/kernel.py:56",
         "launches": hpc_counts["gemm_wgmma"],
         "variants": tuning_entry(
             tuning_launches, tuning_rows, ["gemm"],
             HPC_SOURCES + "gemm/csrc/gemm_wgmma_variants.cu", "wgmma",
             "bf16"),
         **hpc_rows["gemm_bf16"]},
        {"name": "spmv_blockell", "route": "cuda",
         "source": HPC_SOURCES + "spmv/csrc/spmv.cu",
         "replaces": f"{TPU_HPC}spmv/kernel.py:52",
         "launches": hpc_counts["spmv_blockell"],
         **hpc_rows["spmv_blockell"]},
        {"name": "spmv_fixed_width", "route": "cuda",
         "source": HPC_SOURCES + "spmv/csrc/spmv.cu",
         "replaces": f"{TPU_HPC}spmv/kernel.py:82",
         "launches": hpc_counts["spmv_fixed_width"],
         **hpc_rows["spmv_fixed_width"]},
        {"name": "jacobi_step", "route": "cuda",
         "source": HPC_SOURCES + "jacobi2d/csrc/jacobi2d.cu",
         "replaces": f"{TPU_HPC}jacobi2d/kernel.py:52",
         "launches": hpc_counts["jacobi_step"],
         "variants": tuning_entry(
             tuning_launches, tuning_rows, ["jacobi2d"],
             HPC_SOURCES + "jacobi2d/csrc/jacobi2d_variants.cu"),
         **hpc_rows["jacobi_step"]},
        {"name": "flash_decode", "route": "cuda",
         "source": SOURCE_DIR + "flash_decode_paged.cuh",
         "replaces": f"{TPU_KERNELS}:89",
         "launches": hpc_counts["flash_decode"],
         "serve_wave_launches": wave_launches,
         "scenario_launches": scenario_counts["flash_decode"],
         "wave_shapes": {f"{arch} B{WAVE_B} S{WAVE_S} len {WAVE_LEN}": row
                         for arch, row in wave_rows.items()},
         "whisper_decode_launches": whisper_launches,
         "whisper_shapes": {
             f"{name} B{WHISPER_B} S{S} KV20 G1 D64": whisper_rows[name]
             for name, S in (("cross", WHISPER_FRAMES),
                             ("self", WHISPER_MAX_LEN))},
         "shape": "qwen3-1.7b heads, B32 S4096 ragged, bf16",
         "ms_by_shape": {f"{arch} {lengths}": row["ms"]
                         for (arch, lengths), row in fd_rows.items()},
         "variants": tuning_entry(tuning_launches, tuning_rows,
                                  ["flash-decode"], "launch argument "
                                  "split_rows of " + SOURCE_DIR
                                  + "flash_decode_paged.cuh"),
         **fd_rows["qwen3-1.7b", "ragged"]},
        {"name": "rx_gate", "route": "cuda",
         "source": HPC_SOURCES + "qc_gate/csrc/rx_gate.cu",
         "replaces": f"{TPU_QC}:63",
         "launches": hpc_counts["rx_gate"],
         "suite_launches": suite_launches,
         "shape": "28 qubits, qubit 13, fp32",
         "ms_by_qubit": {q: row["ms"] for q, row in rx_gates.items()},
         "layer_ms": {n: row["ms"] for n, row in rx_layers.items()},
         "variants": tuning_entry(
             tuning_launches, tuning_rows, ["qc-gate"],
             HPC_SOURCES + "qc_gate/csrc/rx_gate_variants.cu"),
         **rx_gates[13]},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
