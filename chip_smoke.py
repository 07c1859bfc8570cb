#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of AA-SVD (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --only lowrank   # phases 1-2 and lowrank_matmul
    python3 chip_smoke.py --only cov       # phases 1-2, cov_accum (banked too)
    python3 chip_smoke.py --only grouped   # phases 1-2 and grouped_matmul
    python3 chip_smoke.py --only attention # phases 1-2 and flash_attention
    python3 chip_smoke.py --only decode    # phases 1-2 and flash_decode
    python3 chip_smoke.py --only kimi      # phases 1-2, phase 4's kimi-k2
                                           # smoke runs and phase 12
    python3 chip_smoke.py --only ssm       # phases 1-2, phase 4's
                                           # falcon-mamba and zamba2 smoke
                                           # runs and phase 13
    python3 chip_smoke.py --only train     # phases 1-2 and phase 15
    python3 chip_smoke.py --only zoo       # phases 1-2 and phase 16

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the hand-written kernels (``src/repro_torch/csrc``);
             prints nvcc's version, each kernel's registers and spills
             (``-Xptxas -v``; the wgmma bodies of flash_attention and
             flash_decode and flash_attention's split_mma body must not
             spill, and ptxas must not serialize flash_attention's wgmma
             body) and whether every wgmma body's
             SASS holds HGMMA
             (``cuobjdump``, where the toolkit has it).
3. kernels — every kernel against its plain PyTorch version on the card, at
             the main paths' shapes and ragged ones, in fp32 and bf16, with
             times (CUDA events, median of 10 runs after warm-up), the plain
             version's time, one PyTorch yardstick (``library_ms``) where a
             single call computes the same function, and the card's least
             time for the same work (``bound_ms``); ``grouped_matmul`` also
             at decode's 48 rows over 64 experts (timed), with each row's
             tail-tile waste, backward (dx, dW) against autograd through its
             plain version at a refinement shape and the ragged one (bf16
             timed at the first; dx alone beside ``torch._grouped_mm``, dW
             alone beside its 2-D x 2-D form grouped along the rows), and
             its rows bit for bit the same when
             they run again behind extra rows of other experts (every
             segment offset moved; bf16, forward and dx); ``flash_attention``
             at MLA prefill's head dim 192, at gemma3's head dim 256 (a
             local layer's windowed prefill, a global layer's, the Server's
             8 x 512 prompts, decode over a global layer's dense cache, and
             ragged D-256 shapes through every body), its split body (Lq 1)
             at decode and a ragged shape, with ``device_ms`` / ``library_device_ms``
             beside ``ms`` and, where the mask is plain causal at offset 0,
             ``scaled_dot_product_attention(is_causal=True)`` as a second
             yardstick (``library_causal_ms``); the prefill case's rows
             (and gemma3's windowed and global D-256 rows, kimi-k2's
             D-112, phi-3-vision's D-96 and whisper's non-causal D-64
             encoder rows) bit for bit the same when
             computed again inside chunks of 256, 8 and 1 rows under
             ``batch_invariant``, two calls of every one-row case bit for
             bit equal, and three split decodes profiled: D-112 zamba2's
             (``flash_split`` and ``flash_merge`` its only device work:
             head dims 96 and 112 are read in place, never padded), and
             gemma3's and kimi-k2's GQA decodes (``flash_split_mma`` and
             ``flash_merge`` alone), and two prefills: whisper's encoder
             and gemma3's global layer (``flash_wgmma`` alone); whisper's
             decoder self-attention (causal, D 64) timed beside
             ``is_causal`` SDPA; ragged D-64 and D-256 cases through the
             wgmma body; ``split_mma``, the tensor-core GQA
             decode (bf16, D 64-256, 2 to 16 query heads a KV head), at
             qwen3-0.6b's decode and ragged cases (g 2 to 16, a window, a
             soft cap, per-slot offsets, Lk 333, a span with no live key);
             each row hashes its output (``out_sha256``) and each timed
             row gives its launches' device times apart
             (``kernels_device_ms``).  ``lowrank_matmul`` at T 4096,
             256 and 8 for each llama shape, ragged T through every body,
             and T 1-64 with each bf16 body forced; beside its ``ms`` (one
             call between CUDA events, as every kernel is timed) it gives
             ``device_ms``: the device time of one call in a run of launches
             replayed from a CUDA graph, the L2 evicted before each (no host
             time, no launch start-up), and the same for the yardstick
             (``library_device_ms``); and x @ V alone (``lowrank_down``,
             the latent cache's projections) under each body, and t @ U
             alone (``lowrank_up``) bit for bit equal to its own t @ U.
             ``cov_accum`` at llama-7b's taps, MLA's kv_lora tap (T split),
             one expert segment and ragged shapes; xx and xpxp exactly
             symmetric, and two calls with T split give the same bits, in
             fp32 and bf16.  ``cov_accum_banked`` (one launch over every
             expert bank) at phase 8's two bank taps (64 experts, C 480,
             n 2048 and 1408; bf16 with acc= timed, ``device_ms`` beside
             ``ms``, three ``torch.baddbmm`` on fp32 upcasts as the
             yardstick, and the drop-free route's E ``cov_accum`` launches
             on the same triples) and ragged ones (C 130 / 600, n 72 /
             100, E 3), each bank against the plain version and exactly
             symmetric; two calls bitwise equal, and a bank's bits
             unchanged when every other bank gets new inputs.  ``flash_decode`` at the llama-7b serving case
             (8 slots, lengths 256-2048, rank 1232), granite-3-8b's GQA
             one (32 query heads on 8 KV heads, rank 496), and ragged ones
             (D 16 with odd ranks; bf16 D 64 with 4 query heads a KV
             head; granite's and phi3-medium's smoke head dims 8 and 20),
             fp32 and bf16, with the plan's keys body, ``device_ms``
             beside ``ms`` and two bounds (fp32 FMA, and the tensor-core
             work of the bf16 body); each slot of the llama case computed
             alone (one slot, its cache cut to its own length) bit for bit
             equal to the same slot inside the batch, fp32 and bf16.
             kimi-k2's shapes (phase 12): ``flash_decode`` at head dim 112
             (64 query heads on 8 KV heads, rank 480: the wgmma body in
             bf16, the FMA body in fp32, each slot alone bit for bit; an
             odd rank through the FMA body in both dtypes),
             ``flash_attention`` at head dim 112 read at its true width
             (a compression microbatch's prefill and dense-cache decode),
             ``lowrank_matmul`` at its six factorized shapes and each T,
             ``cov_accum`` at n 7168 and 18432, ``cov_accum_banked`` at
             its two capacity bank taps (E 32, C 1280, n 7168 and 2048).
             Phase 13's shapes: ``flash_decode`` at zamba2's shared block
             (head dim 112, one query head a KV head: 32 on 32, rank 1080;
             bf16 wgmma and fp32 FMA bodies timed, each slot alone bit for
             bit; g 1 at D 112 with an odd rank and with rank 24),
             ``flash_attention`` at D 112 MHA (prefill B 4, L 1024; the
             split body at B 8, Lk 2048), ``lowrank_matmul`` at
             zamba2's and falcon-mamba's nine factorized shapes (T 4096;
             T 256 and 8 too where the widths are ragged: in_proj 14576
             wide, x_proj 288, dt_proj from 256), ``cov_accum`` at n 256,
             8192 and 14336, and a strided tap (the first 256 columns of a
             288-wide buffer, as Mamba1's dt_proj tap is) bit for bit the
             contiguous call.
             ``flash_attention``'s backward (``csrc/flash_attention_bwd.cu``)
             on every case above with Lq > 1 and the ragged ones, fp32 and
             bf16: (dq, dk, dv) against the plain backward (the fp32 einsum
             scan recomputed and differentiated, rel Frobenius 2e-5 fp32 /
             2e-2 bf16), two launches bit for bit equal, the forward's output
             bit for bit the same with and without the LSE it writes; the
             main paths' bf16 cases timed (``device_ms`` with the L2 cold,
             the plain backward, the backward's bound: 2.5x the forward's
             products, q, k, v, o, dO read and dq, dk, dv written once).
             ``--only lowrank`` / ``--only cov`` / ``--only grouped`` /
             ``--only attention`` / ``--only decode`` run phases 1-2 and
             that kernel's rows alone (``--only attention --cases a,b``:
             those flash_attention cases alone).
4. smoke   — the smoke compression recipe on the card (kernels) and on the
             CPU (plain versions) from the same params and tokens; then the
             compressed smoke model served on both (continuous batching over
             the latent cache at chunk 8 and chunk 0, and the fixed-batch
             server): tokens equal, logits held to a stated tolerance.  Then deepseek-v2-lite's
             smoke config compressed with drop-free MoE dispatch on both:
             routed expert ids equal, composed maps (per expert) and loss
             held to stated tolerances; a second compression on the card
             gives the same bits.  The same again with the config's own
             capacity dispatch (factor 1.25): routed ids, the dropped
             choices and the report's drop rates exactly equal card against
             CPU.  Each compressed deepseek smoke model is then served on
             both the same way, over MLA's {"c", "kr"} cache under its
             dispatch.  Then qwen3, granite, phi3-medium and gemma3 smoke
             (16 x 32 tokens) the same way as llama: ranks equal, maps and
             loss held, served on both with equal tokens (gemma3's prompts
             past its window of 8, so the rings wrap).  Then the
             calibration policies: llama smoke with ``rank_mode=
             "adaptive"``, ``calib_mode="hybrid"`` and ``replay_taps=
             "auto"`` (ranks and replay taps equal, maps 1e-3, replayed
             groups on their shifted stream), saved, restored onto the card
             bit for bit and served by ``Server.from_checkpoint`` (tokens
             equal the in-memory ``Server``'s); deepseek smoke drop-free
             with adaptive ranks (routed ids exact, ``rank_per_expert``
             tuples equal).  Each adaptive run prints the allocator's
             smallest relative lambda gap.  Then kimi-k2 smoke (GQA over a
             MoE, one shared expert) under its capacity dispatch and under
             drop-free, card against CPU on 16 x 32 tokens: routed ids,
             ranks and drop rates equal, maps 1e-3 (the capacity banks on
             their shifted stream), served on both with equal tokens.
             Then falcon-mamba and zamba2 smoke on 32 x 32 tokens, card
             against CPU: ranks, unit names and zamba2's reused shared
             site equal, maps 1e-3 (the shared block's included), loss
             1e-3; served on both (every request exact-length whole
             prefill; zamba2's engine over the latent and the dense
             cache) with equal tokens.
5. main    — Algorithm 2 on llama-7b at its published widths, depth cut to
             2 layers, random weights from a seeded ``torch.Generator``:
             calibration 8 × 1024 tokens, ratio 0.6, fused calibration, one
             refine epoch; then the dense and compressed eval losses.  The
             kernels' launch counts are zeroed just before and read just
             after; cov_accum, lowrank_matmul and flash_attention must be
             > 0.
6. serve   — phase 5's models served at llama-7b widths under
             ``torch.inference_mode()``: (a) ``Server`` on the dense params,
             batch 8, 512-token prompts, 32 steps; (b)
             ``ContinuousBatchingServer`` on the compressed params, 8 slots,
             max_len 2048, 256-token prefill chunks, 12 requests of 128-1024
             tokens and 64 steps through the latent cache.  Counts are
             zeroed before each and read after: flash_attention > 0 in both,
             flash_decode and lowrank_matmul > 0 in (b), flash_decode's
             bf16 wgmma body among them.  Then latent-cache
             decode against dense-cache decode, and chunked against whole
             prefill (a last chunk of 256 rows and one of 8), on one
             teacher-forced sequence.  Prints time to first
             token, prefill and decode tokens/s, the median decode step,
             cache bytes (latent / dense) and peak device memory.
7. moe     — Algorithm 2 on deepseek-v2-lite-16b at its published widths
             (MLA attention, 64 routed experts top-6 + 2 shared, drop-free
             dispatch), depth cut to 2 layers (one ``mla_dense_first``, one
             ``mla_moe``), random weights from a seeded ``torch.Generator``:
             calibration 8 × 1024 tokens, ratio 0.6, fused calibration, one
             refine epoch; then the dense and compressed eval losses.  Counts
             zeroed just before and read just after: grouped_matmul,
             cov_accum, lowrank_matmul and flash_attention must be > 0.
8. capacity — phase 7 with the config's own dispatch (capacity, factor
             1.25: C 480 slots an expert a microbatch,
             ``moe_dispatch="inherit"``): wall by stage, peak memory, each
             MoE unit's drop rate in [0, 1), finite losses;
             cov_accum_banked > 0 (2 bank taps x 2 microbatches) and
             grouped_matmul == 0; no host sync in the capacity MoE
             forward.
9. serve moe — phase 7's (drop-free) and phase 8's (capacity) compressed
             deepseek-v2-lite served over MLA's compressed {"c", "kr"}
             cache (kv_lora 512 + rope 64 bf16 a token a layer) at phase 6's
             shapes: (a) ``Server``, batch 8, 512-token prompts, 32 steps
             (whole prefill: ``flash_attention``'s wgmma body at head dim
             192); (b) ``ContinuousBatchingServer``, 8 slots, max_len 2048,
             256-token chunks, 12 requests of 128-1024 tokens and 64 steps
             (chunked prefill and decode: absorbed fp32 einsums).  Counts
             zeroed before each and read after: lowrank_matmul > 0,
             flash_decode == 0, grouped_matmul > 0 under drop-free and == 0
             under capacity, flash_attention > 0 in (a) at head dim 192
             only.  Under capacity the drop rates of a prefill and a decode
             step; under drop-free one teacher-forced sequence: decode after
             prefill against the full forward, and chunked prefill (last
             chunks of 256 and 8 rows) against whole prefill, in bf16 and
             fp32 activations, to stated tolerances.  Prints time to first
             token, prefill / decode tokens/s, the median decode step, peak
             memory, cache bytes a token a layer, the decode step's host
             syncs (``set_sync_debug_mode``: none in ``decode_step``, the
             engine step's own uploads and read counted) and one profiled
             engine run's device time by kernel and busy share.
10. gemma  — gemma3-1b at its published widths (head dim 256, 4 query
             heads on 1 KV head, window 512, RoPE theta 1e4 local / 1e6
             global), depth cut 26 -> 8 (one 5 local + 1 global group, then
             the 2-layer local remainder stage), random weights: phase 5's
             recipe, then served at phase 6's shapes by ``Server`` and the
             engine (every request exact-length whole prefill, prompts past
             512 write the ring's L >= W branch); counts zeroed before each
             run: ``flash_attention`` in the wgmma body (prefill, D 256) and
             the split body (decode of the global layers) > 0,
             ``flash_decode`` == 0 (qk_norm keeps the caches dense); decode
             against one forward over 608 positions across the rings' wrap
             (fp32 1e-3; bf16 within twice the bf16 forward's own distance
             from fp32); ring cache bytes against an all-dense cache;
             ``decode_step`` under ``set_sync_debug_mode("error")``; one
             profiled engine run.
11. policies — (a) phase 5's llama-7b configuration, weights, data and
             recipe with ``rank_mode="adaptive"``, ``calib_mode="hybrid"``
             and ``replay_taps="auto"``: the allocation (budget met within
             one lane step), each linear's rank beside its uniform rank,
             each unit's drift, replays and tapped forwards (2·B + 2·R·B;
             unit 0 never replays; the solve sweep issues none), both
             sweeps' stage seconds, the kept triples' bytes, peak memory,
             the eval loss beside phase 5's; then saved with the port's
             ``CheckpointManager``, restored onto the card and served at
             phase 6's shapes by ``Server.from_checkpoint`` and
             ``ContinuousBatchingServer.from_checkpoint``: tokens bit for
             bit the in-memory model's, ``flash_decode`` > 0.  (b) phase
             8's deepseek-v2-lite (capacity) with ``calib_mode="hybrid"``
             and the static replay list: the MoE unit replays its two bank
             taps, the forward law holds, ``cov_accum_banked`` > 0, eval
             CE beside phase 8's.
12. kimi   — kimi-k2 at its published widths (d_model 7168, 64 query
             heads on 8 KV heads of head dim 112, dense FFN 18432, expert
             d_ff 2048, top-8, one shared expert, vocab 163840, capacity
             factor 1.25), depth cut 61 -> 2 (one ``attn_dense_first``,
             one ``attn_moe``) and routed experts 384 -> 32: phase 5's
             recipe (ranks, drop rate, eval CE, peak memory), then served
             at phase 6's shapes: ``Server`` over the dense cache
             (``flash_attention`` at D 112: wgmma prefill, split
             decode), the engine over the latent cache (``flash_decode``
             at head dim 112, every launch in the wgmma body) and over the
             dense one; cache bytes a token a layer; one teacher-forced
             sequence decoded over both caches (fp32 1e-4; bf16 printed);
             ``decode_step`` under ``set_sync_debug_mode("error")``; one
             profiled engine run.
13. ssm    — (a) zamba2-7b at its published widths (d_model 3584, Mamba2
             d_inner 7168 in 112 SSD heads of 64, state 64; one
             weight-shared attention + SwiGLU block every 6 layers: 32
             heads on 32 KV heads of head dim 112, d_ff 14336; vocab
             32000), depth cut 81 -> 13 (two stacked groups of 6
             ``mamba2`` + ``shared_attn``, then a one-layer ``mamba2``
             remainder): phase 5's recipe (the shared block compressed at
             its first site, reused at its second: zero forwards tapped),
             ranks, eval CE, peak memory, then served at phase 6's shapes:
             ``Server`` (dense cache: ``flash_attention`` at D 112,
             split decode), the engine over the latent cache
             (``flash_decode`` at D 112, g 1, every launch in the wgmma
             body) and over the dense one, every request ``whole_exact``;
             cache bytes from the shapes (a shared site's latent 4320 B a
             token against 14336 dense; a mamba2 layer's state 1,835,008 B
             fp32 ``h`` + 43,776 B bf16 ``conv`` a slot), one
             teacher-forced sequence over both caches (fp32 1e-4),
             ``decode_step`` under ``set_sync_debug_mode("error")``, a
             profiled engine run.  (b) falcon-mamba-7b (Mamba1, d_inner
             8192, state 16, dt_rank 256, vocab 65024), depth cut 64 -> 2:
             the same recipe, then ``Server`` (no attention kernel may
             launch), its state bytes (524,288 + 49,152 a layer a slot)
             and a profiled ``generate``.
14. multimodal — whisper-base at full depth and phi-3-vision-4.2b at
             depth 2: phase 5's recipe, then served (``Server``, the engine
             over the latent and the dense cache).
15. train  — the trainer (``launch/train.py``, ``launch/steps.py``,
             ``data/``).  (e) ``flash_attention`` at qwen3-0.6b's training
             shape (B 8, 16 query heads on 8, L 512, D 128, causal, bf16)
             timed beside its plain version, and its backward kernel
             (``device_ms``, at most 0.48 ms) beside the plain backward,
             ``is_causal`` SDPA (``enable_gqa``) forward and forward +
             backward, and the backward's bound.  (a) Every registered arch's
             smoke config (the MoE archs under both dispatches): three fp32
             train steps on the card and on the CPU from the same params and
             numpy batches, losses rel 1e-5 and every param leaf rel 1e-4
             after step 3.  (b) qwen3-0.6b at its published widths and 28
             layers through ``train()``: B 8 x L 512, 100 steps, lr 3e-4, a
             checkpoint every 50; the loss at the first and last log (it must
             fall by 0.5 nats), the median step, tokens/s, the model-flops
             share of 989 TFLOP/s, peak memory, the launches of one step by
             body, its host syncs, a profiled step's busy share and its time
             split (forward, ``flash_wgmma``, the attention backward, the rest
             of the backward, AdamW, the backward kernel's own launches); one
             backward kernel launch a layer in a step.  (d) The trained model
             compressed by AA-SVD (ratio 0.8, fused, one refine epoch) and by
             naive SVD (agnostic, no refinement) on 256 x 512 tokens of
             the port's calibration set; held-out ppl of base, AA-SVD and
             naive (printed, not gated), each wall by stage; then
             ``Server``: 8 prompts of 128 tokens, 32 steps, tokens in vocab.
             (c) The restart: 20 steps with a checkpoint at 10 against the
             run stopped there and resumed: the restored state and every
             batch bit for bit, the resumed params' largest gap, and a
             determinism probe of the backward.
16. zoo    — the conformance harness (``repro_torch.core.zoo``).  (a)
             ``zoo.roundtrip`` for every registered arch at the fp32 smoke
             recipe: compress, ppl, checkpoints padded and re-sliced,
             ``Server.from_checkpoint``, decode; bit parity of both
             restores, token parity, the manifest's meta, bank metadata
             exactly for the MoE family, tokens in vocab and the ppl ratio
             inside the arch's envelope are required; each arch's compress
             and total wall and ``tokens_per_s`` (beside the envelope's
             CPU-runner floor, not gated) printed, launches counted (fp32
             bodies; ``cov_accum_banked`` for the capacity MoEs alone;
             ``grouped_matmul`` and ``flash_decode`` 0: the ``Server``'s
             cache is dense).  (b) The same contract at published widths on
             whisper-base at full depth (bf16 activations, fp32 params,
             8 x 448 calibration, 1500 frames): both restores bit for bit,
             the three servers' tokens equal; the ppl ratio printed.

From phase 4 on, every attention backward on the card must be the
kernel: a counter in place of ``ref.flash_attention_bwd_ref`` counts its
calls on CUDA tensors outside this script's own comparisons, and the run
fails unless it reads 0.  Each compression path that refines attention
must launch ``flash_attention_bwd``.

It prints a ``{"kernels": [...]}`` line, then
``{"ok": true, "device": {...}}`` as the last line.  Long output goes to
``chiprun_out/chip_smoke.log``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"
LOG = OUT / "chip_smoke.log"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# the main path's shapes: T = microbatch 4 x 1024 tokens; (n, k, m) of
# llama-7b's linears at ratio 0.6 (rank multiple 8), plus ragged ones
SIZES = {
    "tokens": 4096,
    # cov_accum (T, n): llama-7b's taps (d_model, d_ff) at T 4096; MLA's
    # kv_lora tap of phase 7 (n 512: T split across blocks); one expert
    # segment of phase 7 (~384 routed rows at n 2048); then ragged ones (n
    # not a multiple of the tile, T not of the token step, n not of 8);
    # kimi-k2's d_model tap and its dense FFN's down tap (n 18432) as phase
    # 12 collects them.  bf16 acc= is timed at all but the ragged ones
    # phase 13's SSM taps: falcon-mamba's dt_proj_in (n 256) and x_proj_in /
    # out_proj_in (d_inner 8192), zamba2's shared FFN down tap (n 14336);
    # phase 14's: whisper's encoder taps and xattn/kv_in (T 4 x 1500 frames
    # at d_model 512, and its FFN down tap at d_ff 2048), phi-3-vision's
    # d_model tap (4 x (256 + 768) rows at 3072; its d_ff 8192 is above)
    "cov": ((4096, 4096), (4096, 11008), (4096, 512), (384, 2048),
            (4096, 7168), (4096, 18432), (4096, 256), (4096, 8192),
            (4096, 14336), (6000, 512), (6000, 2048), (4096, 3072),
            (4096, 80), (77, 203)),
    "cov_timed": 12,
    # a strided tap (T, n of a (T, width) buffer): falcon-mamba's dt_proj_in
    # is the first dt_rank 256 columns of x_proj's 288-wide output; the
    # wrapper copies it to contiguous rows, bit for bit the same triple
    "cov_strided": (4096, 288, 256),
    # two calls at this (T, n) must give the same bits (T split)
    "cov_repeat": (4096, 512),
    # cov_accum_banked (E, C, n): phase 8's two capacity bank taps at
    # deepseek-v2-lite's widths (64 experts, C 480 at microbatch 4 x 1024
    # tokens, top-6, factor 1.25; d_model 2048 and expert d_ff 1408), timed
    # in bf16 with acc=; then ragged ones: C not a multiple of the 64-row
    # step, n not of the strip, T split (fp32 at 130 rows, bf16 at 600)
    "cov_banked": ((64, 480, 2048), (64, 480, 1408), (3, 130, 72),
                   (3, 130, 100), (3, 600, 100)),
    "cov_banked_timed": 2,
    # two calls bitwise equal, and each bank's bits independent of the
    # other banks' inputs, at these (E, C, n) in fp32 and bf16
    "cov_banked_repeat": ((64, 480, 1408), (3, 130, 100), (3, 600, 100)),
    # kimi-k2's two capacity bank taps in phase 12 (32 experts, C 1280 at
    # microbatch 4 x 1024 tokens, top-8, factor 1.25; d_model 7168 and
    # expert d_ff 2048): bf16, written (no acc=: three E x n x n fp32
    # outputs are 19.7 GB at n 7168, and the check holds two sets), then
    # timed adding into acc=
    "cov_banked_kimi": ((32, 1280, 7168), (32, 1280, 2048)),
    "lowrank_nkm": ((4096, 1232, 4096), (4096, 1792, 11008),
                    (11008, 1792, 4096), (64, 19, 160)),
    # lowrank_matmul rows per llama shape: T 4096 (compression, eval, whole
    # prefill), 256 (the engine's prefill chunk), 8 (decode of 8 slots);
    # ragged T through both bodies; each bf16 body forced at small T
    "lowrank_T": (4096, 256, 8),
    # deepseek-v2-lite's factorized linears as phases 7 and 8 compress them
    # (ratio 0.6): wq, wkv_a, wk_b / wv_b, wo, the dense-first FFN's gate /
    # up and down, the shared experts' gate / up and down; phase 9 runs
    # them at each T of lowrank_T (Server prefill 8 x 512, chunk, decode)
    "lowrank_nkm_moe": ((2048, 744, 3072), (2048, 272, 576), (512, 248, 2048),
                        (2048, 616, 2048), (2048, 1040, 10944),
                        (10944, 1040, 2048), (2048, 712, 2816),
                        (2816, 712, 2048)),
    # kimi-k2's factorized linears as phase 12 compresses them (ratio 0.6,
    # rank multiple 8): wq / wo, wk / wv (kv 8 x 112 = 896 wide), the dense
    # FFN's gate / up and down (d_ff 18432), the experts' and the shared
    # expert's gate / up and down (d_ff 2048)
    "lowrank_nkm_kimi": ((7168, 2152, 7168), (7168, 480, 896),
                         (7168, 3096, 18432), (18432, 3096, 7168),
                         (7168, 960, 2048), (2048, 960, 7168)),
    # phase 13's factorized linears (ratio 0.6, rank multiple 8), with the
    # row counts each is checked at: zamba2's in_proj (out width 2·7168 +
    # 2·64 + 112 heads = 14576) and out_proj, its shared block's wq / wk /
    # wv / wo, gate / up and down; falcon-mamba's in_proj, x_proj (out 256 +
    # 2·16 = 288), dt_proj (in 256) and out_proj.  T 4096 (compression),
    # and 256 (an engine chunk) and 8 (decode of 8 slots) for the four
    # whose widths are ragged
    "lowrank_nkm_ssm": (((3584, 1728, 14576), (4096, 256, 8)),
                        ((7168, 1440, 3584), (4096, 256, 8)),
                        ((3584, 1080, 3584), (4096,)),
                        ((3584, 1720, 14336), (4096,)),
                        ((14336, 1720, 3584), (4096,)),
                        ((4096, 1968, 16384), (4096,)),
                        ((8192, 168, 288), (4096, 256, 8)),
                        ((256, 152, 8192), (4096, 256, 8)),
                        ((8192, 1640, 4096), (4096,))),
    "lowrank_ragged_T": (1, 3, 77, 129),
    "lowrank_forced_T": (1, 3, 8, 16, 32, 64),
    "layers": 2,
    "calib": (8, 1024),
    "microbatch": 4,
    "evals": (2, 4, 1024),
    # flash_attention: (name, B, H, KV, Lq, Lk, D, causal, window, softcap,
    # q_offset: an int or (lo, hi) spread over the B slots); the first three
    # are serving's shapes at llama-7b (whole prefill, a 256-token chunk or
    # latent prefill against a 2048 cache, dense decode of 8 slots), the
    # fourth deepseek-v2-lite's MLA prefill in phase 7 (microbatch 4, 16
    # heads, head dim qk_nope 128 + qk_rope 64), the fifth its whole prefill
    # in phase 9's Server (8 x 512); then gemma3-1b's head dim 256 (4 query
    # heads on 1 KV head) as phase 10 runs it: a local layer's windowed
    # prefill and a global layer's in compression (microbatch 4 x 1024),
    # the Server's 8 x 512 prompts, and decode over a global layer's dense
    # cache of 8 slots (the split body); all but "ragged" are timed
    "flash_attention": (
        ("prefill", 1, 32, 32, 1024, 1024, 128, True, 0, 0.0, 0),
        ("chunk", 1, 32, 32, 256, 2048, 128, True, 0, 0.0, 768),
        ("decode", 8, 32, 32, 1, 2048, 128, True, 0, 0.0, (100, 2047)),
        ("mla_prefill", 4, 16, 16, 1024, 1024, 192, True, 0, 0.0, 0),
        ("mla_server", 8, 16, 16, 512, 512, 192, True, 0, 0.0, 0),
        ("gemma_local", 4, 4, 1, 1024, 1024, 256, True, 512, 0.0, 0),
        ("gemma_global", 4, 4, 1, 1024, 1024, 256, True, 0, 0.0, 0),
        ("gemma_server", 8, 4, 1, 512, 512, 256, True, 512, 0.0, 0),
        ("gemma_decode", 8, 4, 1, 1, 2048, 256, True, 0, 0.0, (100, 2047)),
        # kimi-k2's head dim 112 (64 query heads on 8 KV heads), read at its
        # true width: a compression microbatch's prefill (phase 12) and
        # decode over its dense cache of 8 slots (the split body)
        ("kimi_prefill", 4, 64, 8, 1024, 1024, 112, True, 0, 0.0, 0),
        ("kimi_decode", 8, 64, 8, 1, 2048, 112, True, 0, 0.0, (100, 2047)),
        # zamba2's shared block (phase 13): head dim 112 MHA (32 heads, KV
        # 32), a compression microbatch's prefill and decode over its dense
        # cache of 8 slots (the split body)
        ("zamba2_prefill", 4, 32, 32, 1024, 1024, 112, True, 0, 0.0, 0),
        ("zamba2_decode", 8, 32, 32, 1, 2048, 112, True, 0, 0.0,
         (100, 2047)),
        # whisper-base (phase 14): head dim 64, 8 heads, non-causal over
        # the 1500 frames: the encoder's self-attention of a compression
        # microbatch (1500 x 1500), the decoder's cross-attention of 448
        # tokens, and its decode (Lq 1 against 1500 frames: the split body)
        ("whisper_encoder", 4, 8, 8, 1500, 1500, 64, False, 0, 0.0, 0),
        ("whisper_cross", 4, 8, 8, 448, 1500, 64, False, 0, 0.0, 0),
        ("whisper_cross_decode", 8, 8, 8, 1, 1500, 64, False, 0, 0.0, 0),
        # the decoder's causal self-attention of a compression microbatch
        # (4 x 448 tokens)
        ("whisper_decoder", 4, 8, 8, 448, 448, 64, True, 0, 0.0, 0),
        # phi-3-vision-4.2b (phase 14): head dim 96, a compression
        # microbatch's prefill (256 patches + 768 tokens) and decode over
        # its dense cache of 8 slots (the split body)
        ("vision_prefill", 4, 32, 32, 1024, 1024, 96, True, 0, 0.0, 0),
        ("vision_decode", 8, 32, 32, 1, 2048, 96, True, 0, 0.0,
         (100, 2047)),
        ("ragged", 2, 4, 2, 77, 77, 16, True, 16, 30.0, 0)),
    # flash_attention at ragged shapes through its new bodies: the split
    # body (Lq 1 outside batch_invariant; "decode" above is the other split
    # case) and the wgmma body (bf16; fp32 takes the FMA body) with GQA,
    # window, soft cap, per-slot offsets, Lk not a multiple of the key
    # tile, a query block whose second warpgroup holds no row; and
    # non-causal at head dim 192 with Lq > Lk; at head dim 256 (g 4) a
    # window, per-slot offsets and Lk not a multiple of the key tile through
    # the wgmma and fp32 tile bodies, and the same through the split body;
    # head dims 112 (g 4) and 96 likewise, and 96 non-causal with Lq > Lk
    "flash_attention_ragged": (
        ("ragged_decode", 3, 4, 2, 1, 77, 16, True, 16, 30.0, (0, 76)),
        ("ragged_wgmma", 2, 4, 2, 77, 200, 64, True, 48, 30.0, (5, 100)),
        ("noncausal_d192", 1, 2, 1, 130, 70, 192, False, 0, 0.0, 0),
        ("ragged_d256", 3, 4, 1, 70, 333, 256, True, 100, 0.0, (5, 263)),
        ("ragged_decode_d256", 3, 4, 1, 1, 333, 256, True, 100, 0.0,
         (0, 332)),
        ("ragged_d112", 3, 8, 2, 70, 333, 112, True, 100, 30.0, (5, 263)),
        ("ragged_decode_d112", 3, 8, 2, 1, 333, 112, True, 100, 0.0,
         (0, 332)),
        ("ragged_d96", 2, 4, 4, 200, 77, 96, False, 0, 0.0, 0),
        ("ragged_decode_d96", 3, 4, 4, 1, 333, 96, True, 0, 30.0,
         (0, 332)),
        # the tensor-core GQA decode (split_mma) beside gemma_decode (g 4,
        # D 256), kimi_decode (g 8, D 112) and the two ragged GQA decodes
        # above: qwen3-0.6b's 16 query heads on 8 (g 2, D 128) over 8
        # slots' dense cache; g 16 at D 64 with a soft cap; D 96 with a
        # window and a slot whose second span holds no live key; D 192
        # with a window and a soft cap; D 256 non-causal; Lk 333 is no
        # multiple of a tile
        ("qwen3_decode", 8, 16, 8, 1, 2048, 128, True, 0, 0.0, (100, 2047)),
        ("ragged_mma_g16_d64", 2, 16, 1, 1, 333, 64, True, 0, 30.0,
         (0, 332)),
        ("ragged_mma_g4_d96", 3, 8, 2, 1, 333, 96, True, 100, 0.0,
         (5, 332)),
        ("ragged_mma_g2_d192", 3, 4, 2, 1, 333, 192, True, 64, 30.0,
         (10, 332)),
        ("ragged_mma_g8_d256", 2, 8, 1, 1, 333, 256, False, 0, 0.0, 0),
        # the wgmma body at D 64 (its two warpgroups taking turns) and D
        # 256: non-causal with a last query block of 62 rows (its second
        # warpgroup holds none) and Lk 333 (no multiple of a tile); causal
        # with per-slot offsets (whisper's decoder self-attention) and a
        # last block whose second warpgroup holds 8 rows; at D 256 Lq under
        # one warpgroup, and rows that end mid-warpgroup, with a window and
        # a soft cap
        ("ragged_d64_noncausal", 2, 4, 4, 190, 333, 64, False, 0, 0.0, 0),
        ("ragged_d64_offsets", 3, 8, 8, 200, 333, 64, True, 0, 0.0,
         (0, 133)),
        ("ragged_d256_short", 2, 4, 1, 40, 77, 256, True, 0, 0.0, (0, 37)),
        ("ragged_d256_mid", 2, 8, 2, 100, 333, 256, True, 64, 30.0,
         (3, 233))),
    # the backward alone (the forward is not held to the plain version on
    # them): slots with rows that see no key, which add dO/Lk to every
    # key's dv — causal rows before key 0 (slot 0 at -30) and windowed rows
    # past the last key's window (slot 1 at 150: rows 89-99), and a slot
    # that is all such rows (at -70)
    "flash_attention_bwd_dead": (
        ("dead_d64", 2, 4, 2, 100, 200, 64, True, 40, 0.0, (-30, 150)),
        ("dead_d128_slot", 2, 4, 4, 70, 90, 128, True, 0, 0.0, (-70, 5))),
    # the row-invariance check: the prefill case's rows (and gemma_local's,
    # head dim 256 with a window; kimi's, head dim 112 with GQA; vision's,
    # head dim 96) computed again in chunks of Lq rows starting at these
    # rows, under batch_invariant
    "flash_attention_rows": ((256, (0, 256, 512, 768)), (8, (0, 100, 1016)),
                             (1, (0, 77, 1023))),
    "flash_attention_rows_cases": ("prefill", "gemma_local", "kimi_prefill",
                                   "vision_prefill", "whisper_encoder",
                                   "gemma_global"),
    # the profiled calls: D 112 over zamba2's dense cache (split), gemma3's
    # and kimi-k2's GQA decodes (split_mma), whisper's encoder and gemma3's
    # global prefill (wgmma)
    "flash_attention_profiled": ("zamba2_decode", "gemma_decode",
                                 "kimi_decode", "whisper_encoder",
                                 "gemma_global"),
    # grouped_matmul: (name, M, d, f, E) — phase 7's expert GEMMs, M = 4 x
    # 1024 tokens x top-6 routed rows over 64 experts: the dense bank's
    # gate/up and down, the factorized banks' x @ V and t @ U at rank 504;
    # the dense gate/up at decode's M = 8 slots x top-6 and at an engine
    # chunk's M = 256 x top-6; the factorized banks at those two M (phase 9
    # serves them); then ragged cases: f 136 (the last column
    # tile 8 wide: its second 64-column box is wholly past f and not
    # loaded), and f not a multiple of 8, M not of the row tile.  Group
    # sizes: a skewed numpy draw with two experts empty
    "grouped": (
        ("gate_up", 24576, 2048, 1408, 64),
        ("down", 24576, 1408, 2048, 64),
        ("gate_up_v", 24576, 2048, 504, 64),
        ("gate_up_u", 24576, 504, 1408, 64),
        ("down_v", 24576, 1408, 504, 64),
        ("down_u", 24576, 504, 2048, 64),
        ("decode", 48, 2048, 1408, 64),
        ("serve_chunk", 1536, 2048, 1408, 64),
        ("decode_v", 48, 2048, 504, 64),
        ("decode_u", 48, 504, 1408, 64),
        ("decode_down_v", 48, 1408, 504, 64),
        ("decode_down_u", 48, 504, 2048, 64),
        ("chunk_v", 1536, 2048, 504, 64),
        ("chunk_u", 1536, 504, 1408, 64),
        ("chunk_down_v", 1536, 1408, 504, 64),
        ("chunk_down_u", 1536, 504, 2048, 64),
        ("ragged_n", 1000, 200, 136, 7),
        ("ragged", 4133, 200, 77, 9)),
    # the shift-invariance check's cases (names above)
    "grouped_shift": ("gate_up_v", "decode", "ragged_n", "ragged"),
    # phase 7: deepseek-v2-lite at published widths, depth cut 27 -> 2
    "moe_layers": 2,
    # flash_decode: (name, B, H, KV, D, r_k, r_v, L, lengths (lo, hi));
    # llama-7b at ratio 0.6 (rank 1232, PERF.md row 2), then ragged ones:
    # D 16 with odd ranks (the FMA body in both dtypes), and D 64 with 4
    # query heads a KV head, L not a multiple of the 256-key span, a slot
    # of length 1 (the wgmma body in bf16)
    # granite-3-8b's full-width GQA decode (32 query heads on 8 KV heads,
    # wk / wv at rank 496 = ranks.rank_for_ratio(1024, 4096, 0.6)) is timed
    # too; then granite's and phi3-medium's smoke head dims 8 and 20 (the
    # FMA body; RoPE pairs 4 and 10 dims)
    "flash_decode": (
        ("llama", 8, 32, 32, 128, 1232, 1232, 2048, (256, 2048)),
        ("granite", 8, 32, 8, 128, 496, 496, 2048, (256, 2048)),
        ("ragged", 3, 4, 2, 16, 19, 24, 77, (1, 77)),
        ("ragged_d64_g4", 5, 8, 2, 64, 200, 77, 700, (1, 700)),
        ("ragged_d8_g4", 3, 8, 2, 8, 24, 20, 300, (1, 300)),
        ("ragged_d20", 3, 4, 2, 20, 32, 19, 90, (1, 90)),
        # kimi-k2 at ratio 0.6: 64 query heads on 8 KV heads of head dim 112,
        # wk / wv at rank 480 (the wgmma body in bf16), then D 112 at an odd
        # rank (the FMA body in both dtypes) with a slot of length 1
        ("kimi", 8, 64, 8, 112, 480, 480, 2048, (256, 2048)),
        ("ragged_d112", 3, 16, 2, 112, 19, 24, 300, (1, 300)),
        # zamba2's shared block at ratio 0.6: MHA, one query head a KV head
        # (32 on 32) of head dim 112, wk / wv at rank 1080 (the wgmma body
        # in bf16, the FMA body in fp32); then g 1 at D 112 with an odd
        # rank and a slot of length 1
        ("zamba2", 8, 32, 32, 112, 1080, 1080, 2048, (256, 2048)),
        ("ragged_d112_g1", 3, 4, 4, 112, 21, 16, 300, (1, 300)),
        ("ragged_d112_g1_rank8", 3, 4, 4, 112, 24, 40, 300, (1, 300)),
        # whisper-base's decoder at ratio 0.6: 8 heads on 8 KV heads of head
        # dim 64 without RoPE (rope=False: the 10th field), wk / wv at rank
        # 160, 8 slots over its 448 positions; phi-3-vision-4.2b at ratio
        # 0.6: 32 on 32 heads of head dim 96 (RoPE pairs 48 dims), rank 928
        # (the wgmma body in bf16, the FMA body in fp32); then D 96 at an
        # odd rank, and D 64 without RoPE at a ragged shape
        ("whisper", 8, 8, 8, 64, 160, 160, 448, (64, 448), False),
        ("vision", 8, 32, 32, 96, 928, 928, 2048, (256, 2048)),
        ("ragged_d96", 3, 4, 4, 96, 19, 24, 300, (1, 300)),
        ("ragged_d64_norope", 3, 4, 2, 64, 24, 16, 300, (1, 300), False)),
    "flash_decode_timed": ("llama", "granite", "kimi", "zamba2", "whisper",
                           "vision"),
    # each slot alone against the batch, bit for bit
    "flash_decode_alone": ("llama", "kimi", "zamba2", "vision"),
    # serving: Server (batch, prompt, steps, max_len) on the dense model;
    # the engine (slots, max_len, chunk, requests, prompt lo/hi, steps) on
    # the compressed one; the teacher-forced checks (prompt, steps, max_len)
    "serve_dense": (8, 512, 32, 1024),
    "serve_engine": (8, 2048, 256, 12, (128, 1024), 64),
    "serve_check": (512, 16, 1024),
    # phase 4: the dense-attention archs whose smoke configs are compressed
    # and served card against CPU beside llama's
    "smoke_archs": ("qwen3-0.6b", "granite-3-8b", "phi3-medium-14b",
                    "gemma3-1b"),
    # their calibration: 16 x 32 uniform tokens.  The card-vs-CPU gap of
    # the composed maps grows with depth (each unit solves on the stream the
    # compressed units before it made): on gemma3 smoke's 6 layers at 8 x
    # 32 it rose from 4e-6 (unit 0) to 1.25e-3 (unit 5) with the unit MSEs
    # equal to 5 digits; at 16 x 32 the worst was 2.6e-4 (this script's
    # phase 4 on an H100)
    "smoke_calib": (16, 32),
    # phase 10: gemma3-1b at its published widths, depth cut 26 -> 8: one
    # 5 local + 1 global group, then the 2-layer local remainder stage, so
    # both stages run (all 26 layers took the phase 148 s on an H100, 97 s
    # of it the teacher-forced check's host-bound decode steps); the check
    # (prompt, decode steps, max_len): 608 decode positions, 32-639, past
    # the 512-slot rings
    "gemma_layers": 8,
    "gemma_check": (32, 608, 1024),
    # phase 12: kimi-k2 at its published widths, depth cut 61 -> 2 (one
    # attn_dense_first, one attn_moe) and routed experts 384 -> 32: the MoE
    # unit's covariance triples alone take 32 x 12 B x (7168² + 2048²) =
    # 21.3 GB, 42.6 GB at 64 experts
    "kimi_layers": 2,
    "kimi_experts": 32,
    # phase 13: zamba2-7b at its published widths, depth cut 81 -> 13 (two
    # stacked groups of 6 mamba2 + the shared block, then a one-layer
    # mamba2 remainder stage), and falcon-mamba-7b, depth cut 64 -> 2 (one
    # stacked stage)
    "zamba2_layers": 13,
    "falcon_layers": 2,
    # phase 4: the SSM / hybrid smoke configs compressed and served card
    # against CPU, on 32 x 32 tokens: zamba2 smoke's out_proj tap (n 128)
    # sits 7 units deep, and at 16 x 32 its map moved 2.25e-3 card against
    # CPU (6.2e-4 between 1 and 8 CPU threads alone; 1.2e-4 at 32 x 32),
    # the loss equal to 3e-7
    "smoke_ssm_archs": ("falcon-mamba-7b", "zamba2-7b"),
    # phase 4's multimodal archs (frames / patches 0.02·N(0, 1)) on the
    # standard 16 x 32 tokens; ROADMAP 3j's check (--only multimodal): the
    # old sizes of the two checks that moved to larger sets
    "smoke_mm_archs": ("whisper-base", "phi-3-vision-4.2b"),
    "refine_off_3j": (("gemma3-1b", (8, 32)), ("zamba2-7b", (16, 32))),
    # phase 14: whisper-base at full depth (its decoder's 448 positions:
    # calibration 8 x 448 tokens with 8 x 1500 frames; eval 2 x 4 x 448;
    # Server (batch, prompt, steps, max_len); engine (slots, max_len,
    # requests, prompt lo/hi, steps); the teacher-forced check (prompt,
    # steps, max_len)), then phi-3-vision-4.2b at depth 32 -> 2 (256 patches
    # before every prompt: calibration 8 x (256 + 768), Server 8 x (256 +
    # 512))
    "whisper_shapes": {"calib": (8, 448), "evals": (2, 4, 448),
                       "serve_dense": (8, 64, 32, 448),
                       "serve_engine": (8, 448, 12, (64, 320), 64),
                       "serve_check": (128, 16, 448)},
    "vision_shapes": {"calib": (8, 768), "evals": (2, 4, 768),
                      "serve_dense": (8, 512, 32, 1024),
                      "serve_engine": (8, 2048, 12, (128, 1024), 64),
                      "serve_check": (512, 16, 1024)},
    "vision_layers": 2,
    "smoke_calib_ssm": (32, 32),
    # phase 15, the trainer: (b) qwen3-0.6b at its published widths and
    # depth, B 8 x L 512, 100 steps, a checkpoint every 50; (c) the
    # restart: 20 steps, a checkpoint at 10, depth cut 28 -> 2 (at 28 it
    # took 55.7 s, three saves of 7.2 GB, and was bit for bit); (d)
    # the trained model calibrated on 256 x 512 tokens (128 per d_model) in
    # microbatches of 8 (4096 tokens, as phase 5's 4 x 1024), eval 4 x 8 x
    # 512, served by Server: 8 prompts of 128 tokens, 32 steps
    "train_shape": (8, 512),
    "train_steps": 100,
    "train_ckpt_every": 50,
    "train_restart": (20, 10),
    "train_restart_layers": 2,
    "train_calib": (256, 512),
    "train_microbatch": 8,
    "train_evals": (4, 8, 512),
    "train_serve": (8, 128, 32),
    # phase 17, the autotuner: every candidate of each lattice at llama-7b's
    # main path at published widths ((n, k, m) at each T; the covariance at
    # its d_model and d_ff taps and MLA's kv_lora tap; the prefill and the
    # dense-cache decode of phase 3; the latent-cache decode; deepseek's
    # expert GEMM at a microbatch's 24576 rows and decode's 48) and kimi-k2's
    # capacity bank tap (E 32, C 1280, n 7168)
    "autotune_lowrank": ((4096, 1232, 4096), (4096, 1792, 11008),
                         (11008, 1792, 4096)),
    "autotune_T": (4096, 256, 8),
    "autotune_cov": ((4096, 4096), (4096, 11008), (4096, 512)),
    "autotune_flash": ("prefill", "decode"),
    "autotune_decode": ("llama",),
    "autotune_grouped": ("gate_up", "decode"),
    "autotune_bank": (32, 1280, 7168),
}


class PhaseError(RuntimeError):
    pass


def log(*args):
    line = " ".join(str(a) for a in args)
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing


def time_ms(fn, *, warmup=3, reps=10):
    """Median device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events around each run, after ``warmup`` runs)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


FLUSH_BYTES = 256 << 20   # a read this large evicts the H100's 50 MB L2


def device_ms(fn, *, calls=10, reps=5):
    """Device milliseconds of one ``fn()`` in a run of ``calls`` launches:
    CUDA events around a replay of a CUDA graph holding the run (so no host
    time is counted), over ``calls``, median of ``reps`` replays after 3
    eager warm-up runs.  A 256 MB read precedes each call in the graph,
    evicting the L2 as a decode step finds each linear's factors (read once
    a step); a graph of the reads alone is timed the same way and taken
    off.  The cuBLAS workspaces that capture leaves behind are freed after,
    so later phases' peak memory does not carry them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")

    def run(with_fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                flush.sum()     # a read: leaves the L2 clean, no write-back
                if with_fn:
                    fn()
        times = []
        for _ in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return statistics.median(times[1:])

    ms = (run(True) - run(False)) / calls
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return ms


def kernel_ms(fn, *, calls=10):
    """{kernel name: device ms of one ``fn()``} from ``torch.profiler``
    over ``calls`` calls after one warm-up (each launch's own device time;
    the gaps between launches are not counted)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+)(<[^(]*>)?\(", evt.key)
            name = m.group(1) + (m.group(2) or "") if m else evt.key[:60]
            out[name] = out.get(name, 0.0) + (evt.self_device_time_total
                                              / 1e3 / calls)
    return out


def lowrank_rows(ops):
    """lowrank_matmul's launches since the last reset, by row count T and
    split at 16 (the small-T body's bf16 limit) and 64."""
    rows = dict(sorted(ops.LOWRANK_ROWS.items()))
    return {"by_rows": rows,
            "rows<=16": sum(c for t, c in rows.items() if t <= 16),
            "rows<=64": sum(c for t, c in rows.items() if t <= 64),
            "rows>64": sum(c for t, c in rows.items() if t > 64)}


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_fro(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def check_cov(torch, ops, ref, t_rows, n, dtype, with_acc, timed, dev):
    gen = torch.Generator(device=dev).manual_seed(n + t_rows)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    xp = (x.float() + 0.1 * torch.randn(t_rows, n, generator=gen,
                                        device=dev)).to(dtype)
    want = ref.cov_accum_ref(x, xp)
    acc0 = None
    if with_acc:
        acc0 = tuple(torch.randn(n, n, generator=gen, device=dev)
                     for _ in range(3))
        want = tuple(a + w for a, w in zip(acc0, want))
        got = ops.cov_accum(x, xp, acc=tuple(a.clone() for a in acc0))
    else:
        got = ops.cov_accum(x, xp)
    err = max(rel_fro(g, w) for g, w in zip(got, want))
    mae = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # fp32 inputs (FMA units): fp32 sums of T products in another order
    # (split T: the slices' partials added in slice order): 1e-5 relative
    # Frobenius.  bf16 inputs (tensor cores): the products are exact, but the
    # tensor cores' fp32 accumulation keeps fewer bits than an FMA chain
    # (9.1e-6 at T 4096 on an H100): 5e-5
    lim = 1e-5 if dtype == torch.float32 else 5e-5
    require(err <= lim, f"cov_accum T={t_rows} n={n} {dtype} acc={with_acc}"
            f": rel err {err:.3e} > {lim:.0e}")
    if not with_acc:
        # the upper triangle is computed once and mirrored
        require(torch.equal(got[0], got[0].T)
                and torch.equal(got[2], got[2].T),
                f"cov_accum T={t_rows} n={n} {dtype}: xx / xpxp not exactly "
                "symmetric")
    row = {"shape": [t_rows, n], "dtype": str(dtype).replace("torch.", ""),
           "acc": with_acc, "rel_fro_err": err, "max_abs_err": mae}
    if timed:
        accs = tuple(torch.zeros(n, n, device=dev) for _ in range(3))
        row["ms"] = time_ms(lambda: ops.cov_accum(
            x, xp, acc=accs if with_acc else None))
        row["plain_ms"] = time_ms(lambda: ref.cov_accum_ref(x, xp))
        # yardstick: the three products as cuBLAS matmuls in the input type
        row["library_ms"] = time_ms(lambda: (torch.matmul(x.T, x),
                                             torch.matmul(x.T, xp),
                                             torch.matmul(xp.T, xp)))
        eb = x.element_size()
        # xxp, plus the distinct halves of the symmetric xx and xpxp
        # (the kernel's 4·T·n², less its diagonal tiles' lower halves)
        flops = 2 * t_rows * n * n + 2 * t_rows * n * (n + 1)
        nbytes = 2 * t_rows * n * eb + 3 * n * n * 4 * (2 if with_acc else 1)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
    return row


def check_lowrank(torch, ops, ref, t_rows, n, k, m, dtype, epilogue, timed,
                  dev, body=None):
    """One lowrank_matmul case against its plain version; ``body`` forces
    a body of the launch plan, None lets the plan choose."""
    from repro_torch.kernels import lowrank_matmul as low
    gen = torch.Generator(device=dev).manual_seed(n + k + m)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    v = (torch.randn(n, k, generator=gen, device=dev) / math.sqrt(n)
         ).to(dtype)
    u = (torch.randn(k, m, generator=gen, device=dev) / math.sqrt(k)
         ).to(dtype)
    bias = res = None
    if epilogue:
        bias = torch.randn(m, generator=gen, device=dev).to(dtype)
        res = torch.randn(t_rows, m, generator=gen, device=dev).to(dtype)
    want = ref.lowrank_matmul_ref(x, v, u)
    if epilogue:
        want = want + bias + res

    def run():
        if body is None:
            return ops.lowrank_matmul(x, v, u, bias=bias, residual=res)
        return ops._lowrank_kernel(x, v, u, bias, res, body=body)[0]

    got = run()
    mae = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        err = rel_fro(got, want)
        require(err <= 1e-5, f"lowrank_matmul {t_rows}x{n}x{k}x{m} fp32 "
                f"epilogue={epilogue}: rel err {err:.3e} > 1e-5")
    else:
        # t rounds to bf16 in both; the epilogue adds run in fp32 in the
        # kernel and after the bf16 cast in the plain version
        lim = 2e-2 * float(want.float().abs().max())
        err = mae
        require(mae <= lim, f"lowrank_matmul {t_rows}x{n}x{k}x{m} bf16 "
                f"epilogue={epilogue}: max abs err {mae:.3e} > {lim:.3e}")
    # the plan the wrapper launched (the tuner's pick; plan() on the CPU)
    from repro_torch.kernels import autotune
    p = autotune.lowrank_plan(t_rows, n, k, m, dtype, body=body,
                              device=dev).plan
    row = {"shape": [t_rows, n, k, m], "dtype": str(dtype)
           .replace("torch.", ""), "epilogue": epilogue, "err": err,
           "max_abs_err": mae, "body": p.body, "forced": body is not None,
           "grid_xv": p.grid("xv"), "grid_tu": p.grid("tu"),
           "tile_rows": [p.tile_rows_xv, p.tile_rows_tu]}
    if timed:
        # ms: one call between CUDA events, as every kernel here is timed
        # (host launch work included); device_ms: the device time alone
        library = lambda: torch.matmul(torch.matmul(x, v), u)  # noqa: E731
        row["ms"] = time_ms(run)
        row["device_ms"] = device_ms(run)
        row["plain_ms"] = time_ms(lambda: ref.lowrank_matmul_ref(x, v, u))
        row["library_ms"] = time_ms(library)
        row["library_device_ms"] = device_ms(library)
        eb = x.element_size()
        flops = 2 * t_rows * k * (n + m)
        nbytes = (t_rows * n + n * k + k * m + t_rows * m) * eb
        if epilogue:
            nbytes += (m + t_rows * m) * eb
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
    return row


def check_lowrank_down(torch, ops, t_rows, n, k, dtype, invariant, dev):
    """``ops.lowrank_down`` (x @ V alone, the serving latents) against the
    plain product rounded once, under the plan's body or, with
    ``invariant``, under ``ops.batch_invariant`` (prefill's); the limits of
    check_lowrank."""
    import contextlib
    gen = torch.Generator(device=dev).manual_seed(n + k + t_rows)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    v = (torch.randn(n, k, generator=gen, device=dev) / math.sqrt(n)
         ).to(dtype)
    want = torch.matmul(x.float(), v.float()).to(dtype)
    with ops.batch_invariant() if invariant else contextlib.nullcontext():
        got = ops.lowrank_down(x, v)
    mae = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        err = rel_fro(got, want)
        require(err <= 1e-5, f"lowrank_down {t_rows}x{n}x{k} fp32 "
                f"invariant={invariant}: rel err {err:.3e} > 1e-5")
    else:
        err = mae
        lim = 2e-2 * float(want.float().abs().max())
        require(mae <= lim, f"lowrank_down {t_rows}x{n}x{k} bf16 "
                f"invariant={invariant}: max abs err {mae:.3e} > {lim:.3e}")
    return {"shape": [t_rows, n, k], "dtype": str(dtype).replace(
        "torch.", ""), "batch_invariant": invariant, "err": err,
        "max_abs_err": mae}


def check_cov_repeat(torch, ops, t_rows, n, dtype, dev):
    """Two calls on the same inputs give the same bits, written and added
    into a symmetric acc= (T split across blocks at this shape), and xx /
    xpxp come out exactly symmetric."""
    from repro_torch.kernels import cov_accum as cov
    p = cov.plan(t_rows, n, dtype)
    require(p.splits > 1, f"cov_accum T={t_rows} n={n} {dtype}: not split")
    gen = torch.Generator(device=dev).manual_seed(3 * n + t_rows)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    xp = (x.float() + 0.1 * torch.randn(t_rows, n, generator=gen,
                                        device=dev)).to(dtype)
    a, b = (torch.randn(n, n, generator=gen, device=dev) for _ in range(2))
    acc0 = ((a + a.T) / 2, torch.randn(n, n, generator=gen, device=dev),
            (b + b.T) / 2)
    runs = []
    for _ in range(2):
        runs.append((ops.cov_accum(x, xp),
                     ops.cov_accum(x, xp, acc=tuple(t.clone()
                                                    for t in acc0))))
    same = all(torch.equal(g, w) for g, w in zip(runs[0][0] + runs[0][1],
                                                 runs[1][0] + runs[1][1]))
    sym = all(torch.equal(o[i], o[i].T) for o in runs[0] for i in (0, 2))
    row = {"shape": [t_rows, n], "dtype": str(dtype).replace("torch.", ""),
           "splits": p.splits, "bitwise_equal": same, "symmetric": sym}
    require(same, f"cov_accum T={t_rows} n={n} {dtype}: two calls differ")
    require(sym, f"cov_accum T={t_rows} n={n} {dtype}: xx / xpxp not exactly "
            "symmetric")
    return row


def check_cov_strided(torch, ops, t_rows, width, n, dtype, dev):
    """cov_accum on the first n columns of a (T, width) buffer (a strided
    view, as Mamba1's dt_proj tap is) gives the bits of the same call on
    those columns copied to contiguous rows."""
    gen = torch.Generator(device=dev).manual_seed(width + n)
    buf = torch.randn(t_rows, width, generator=gen, device=dev).to(dtype)
    bufp = (buf.float() + 0.1 * torch.randn(t_rows, width, generator=gen,
                                            device=dev)).to(dtype)
    x, xp = buf[:, :n], bufp[:, :n]
    got = ops.cov_accum(x, xp)
    want = ops.cov_accum(x.contiguous(), xp.contiguous())
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    require(same, f"cov_accum strided ({t_rows}, {n} of {width}) {dtype}: "
            "differs from the contiguous call")
    return {"shape": [t_rows, n], "width": width,
            "dtype": str(dtype).replace("torch.", ""),
            "strided_bitwise_equal": same}


def phase_cov(torch, ops, ref, dev="cuda", sizes=SIZES):
    """cov_accum at each (T, n) of ``cov`` (fp32 and bf16, written and
    added into acc=; timed in bf16 with acc= at the first ``cov_timed``),
    then the repeat check and the strided-tap check in both dtypes."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import cov_accum as cov
    rows = []
    for i, (t_rows, n) in enumerate(sizes["cov"]):
        for dtype in (torch.float32, torch.bfloat16):
            for with_acc in (False, True):
                timed = (i < sizes["cov_timed"] and dtype == torch.bfloat16
                         and with_acc)
                row = check_cov(torch, ops, ref, t_rows, n, dtype, with_acc,
                                timed, dev)
                p = cov.plan(t_rows, n, dtype)
                tuned = autotune.cov_plan(t_rows, n, dtype, device=dev).plan
                row.update(tiles=p.tiles, splits=tuned.splits,
                           heuristic_splits=p.splits)
                rows.append(row)
                log("cov_accum", json.dumps(row))
    for dtype in (torch.float32, torch.bfloat16):
        row = check_cov_repeat(torch, ops, *sizes["cov_repeat"], dtype, dev)
        rows.append(row)
        log("cov_accum repeat", json.dumps(row))
    if "cov_strided" in sizes:
        for dtype in (torch.float32, torch.bfloat16):
            row = check_cov_strided(torch, ops, *sizes["cov_strided"], dtype,
                                    dev)
            rows.append(row)
            log("cov_accum strided", json.dumps(row))
    return rows


def _banked_inputs(torch, e, c, n, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(e, c, n, generator=gen, device=dev).to(dtype)
    xp = (x.float() + 0.1 * torch.randn(e, c, n, generator=gen,
                                        device=dev)).to(dtype)
    return gen, x, xp


def _banked_library(torch, x, xp, accs):
    """The yardstick: three ``torch.baddbmm`` calls on fp32 upcasts of the
    bf16 inputs (TF32 off), adding into fp32 accumulators: the function
    ``cov_accum_banked(x, xp, acc=accs)`` computes, one PyTorch call a
    term (a bf16 ``bmm`` would round its output to bf16)."""
    xf, xpf = x.float(), xp.float()
    return (torch.baddbmm(accs[0], xf.mT, xf),
            torch.baddbmm(accs[1], xf.mT, xpf),
            torch.baddbmm(accs[2], xpf.mT, xpf))


def check_cov_banked(torch, ops, ref, e, c, n, dtype, with_acc, timed, dev):
    """cov_accum_banked at (E, C, n) against its plain version, bank by
    bank at check_cov's limits, each bank's xx / xpxp exactly symmetric."""
    gen, x, xp = _banked_inputs(torch, e, c, n, dtype, dev, e * n + c)
    want = ref.cov_accum_banked_ref(x, xp)
    if with_acc:
        acc0 = tuple(torch.randn(e, n, n, generator=gen, device=dev)
                     for _ in range(3))
        want = tuple(a + w for a, w in zip(acc0, want))
        got = ops.cov_accum_banked(x, xp, acc=tuple(a.clone() for a in acc0))
        del acc0
    else:
        got = ops.cov_accum_banked(x, xp)
    err = max(rel_fro(g[b], w[b]) for g, w in zip(got, want)
              for b in range(e))
    mae = max(float((g - w).abs().max()) for g, w in zip(got, want))
    lim = 1e-5 if dtype == torch.float32 else 5e-5
    require(err <= lim, f"cov_accum_banked {e}x{c}x{n} {dtype} acc="
            f"{with_acc}: rel err {err:.3e} > {lim:.0e} (worst bank)")
    if not with_acc:
        require(all(torch.equal(got[i], got[i].mT) for i in (0, 2)),
                f"cov_accum_banked {e}x{c}x{n} {dtype}: a bank's xx / xpxp "
                "is not exactly symmetric")
    del got, want
    row = {"shape": [e, c, n], "dtype": str(dtype).replace("torch.", ""),
           "acc": with_acc, "rel_fro_err": err, "max_abs_err": mae}
    if timed:
        # timed adding into acc= (in place: no E x n x n outputs a call)
        row["timed_acc"] = True
        accs = tuple(torch.zeros(e, n, n, device=dev) for _ in range(3))
        run = lambda: ops.cov_accum_banked(x, xp, acc=accs)  # noqa: E731
        row["ms"] = time_ms(run)
        row["device_ms"] = device_ms(run)
        row["plain_ms"] = time_ms(lambda: ref.cov_accum_banked_ref(x, xp))
        row["library_ms"] = time_ms(lambda: _banked_library(torch, x, xp,
                                                            accs))
        row["library"] = "torch.baddbmm x3 on fp32 upcasts (TF32 off)"
        eb = x.element_size()
        flops = e * (2 * c * n * n + 2 * c * n * (n + 1))
        nbytes = 2 * e * c * n * eb + 3 * e * n * n * 4 * 2
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
        # the drop-free dispatch's route to the same triples: one cov_accum
        # launch an expert segment, here E launches of C rows each
        row["per_bank_cov_accum_ms"] = time_ms(lambda: [
            ops.cov_accum(x[b], xp[b], acc=(accs[0][b], accs[1][b],
                                            accs[2][b]))
            for b in range(e)])
        del accs
    return row


def check_cov_banked_repeat(torch, ops, e, c, n, dtype, dev):
    """Two calls give the same bits, written and added into a symmetric
    acc=; then every bank but one gets new random inputs, and that bank's
    three outputs keep their bits (written and added)."""
    from repro_torch.kernels import cov_accum as cov
    gen, x, xp = _banked_inputs(torch, e, c, n, dtype, dev, 7 * n + c)
    a, b = (torch.randn(e, n, n, generator=gen, device=dev)
            for _ in range(2))
    acc0 = ((a + a.mT) / 2, torch.randn(e, n, n, generator=gen, device=dev),
            (b + b.mT) / 2)
    del a, b

    def both(x, xp):
        return (ops.cov_accum_banked(x, xp),
                ops.cov_accum_banked(x, xp, acc=tuple(t.clone()
                                                      for t in acc0)))

    runs = [both(x, xp), both(x, xp)]
    same = all(torch.equal(g, w) for g, w in zip(runs[0][0] + runs[0][1],
                                                 runs[1][0] + runs[1][1]))
    sym = all(torch.equal(o[i], o[i].mT) for o in runs[0] for i in (0, 2))
    keep = e // 2
    x2, xp2 = x.clone(), xp.clone()
    others = [i for i in range(e) if i != keep]
    x2[others] = torch.randn(len(others), c, n, generator=gen,
                             device=dev).to(dtype)
    xp2[others] = torch.randn(len(others), c, n, generator=gen,
                              device=dev).to(dtype)
    moved = both(x2, xp2)
    alone = all(torch.equal(g[keep], w[keep]) for g, w in zip(
        runs[0][0] + runs[0][1], moved[0] + moved[1]))
    changed = not torch.equal(runs[0][0][others[0]], moved[0][0][others[0]])
    p = cov.plan(c, n, dtype, banks=e)
    row = {"shape": [e, c, n], "dtype": str(dtype).replace("torch.", ""),
           "splits": p.splits, "bitwise_equal": same, "symmetric": sym,
           "bank_independent": alone, "bank_kept": keep}
    require(same, f"cov_accum_banked {e}x{c}x{n} {dtype}: two calls differ")
    require(sym, f"cov_accum_banked {e}x{c}x{n} {dtype}: xx / xpxp not "
            "exactly symmetric")
    require(changed, f"cov_accum_banked {e}x{c}x{n} {dtype}: new inputs "
            "left another bank unchanged")
    require(alone, f"cov_accum_banked {e}x{c}x{n} {dtype}: bank {keep}'s "
            "bits moved with the other banks' inputs")
    return row


def phase_cov_banked(torch, ops, ref, dev="cuda", sizes=SIZES):
    """cov_accum_banked at each (E, C, n) of ``cov_banked`` (fp32 and bf16,
    written and added into acc=; timed in bf16 with acc= at the first
    ``cov_banked_timed``), then the repeat and bank-independence checks in
    both dtypes."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import cov_accum as cov
    rows = []
    for i, (e, c, n) in enumerate(sizes["cov_banked"]):
        for dtype in (torch.float32, torch.bfloat16):
            for with_acc in (False, True):
                timed = (i < sizes["cov_banked_timed"]
                         and dtype == torch.bfloat16 and with_acc)
                row = check_cov_banked(torch, ops, ref, e, c, n, dtype,
                                       with_acc, timed, dev)
                p = cov.plan(c, n, dtype, banks=e)
                tuned = autotune.cov_plan(c, n, dtype, banks=e,
                                          device=dev).plan
                row.update(tiles=p.tiles, items=p.items, splits=tuned.splits,
                           heuristic_splits=p.splits)
                rows.append(row)
                log("cov_accum_banked", json.dumps(row))
    for shape in sizes["cov_banked_repeat"]:
        for dtype in (torch.float32, torch.bfloat16):
            row = check_cov_banked_repeat(torch, ops, *shape, dtype, dev)
            rows.append(row)
            log("cov_accum_banked repeat", json.dumps(row))
    # kimi-k2's bank taps: bf16 written, timed into acc= (one set of
    # accumulators at a time: 19.7 GB at n 7168)
    for e, c, n in sizes.get("cov_banked_kimi", ()):
        row = check_cov_banked(torch, ops, ref, e, c, n, torch.bfloat16,
                               False, True, dev)
        p = cov.plan(c, n, torch.bfloat16, banks=e)
        row.update(tiles=p.tiles, items=p.items, splits=p.splits,
                   case="kimi")
        rows.append(row)
        log("cov_accum_banked kimi", json.dumps(row))
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def check_lowrank_up(torch, ops, t_rows, n, k, m, dtype, invariant, dev):
    """``ops.lowrank_up`` (t @ U alone, the latent cache's up-projection)
    on ``lowrank_down``'s t gives the bits of ``lowrank_matmul`` on the same
    rows, at T and on a 2T-row cache holding them first (latent prefill
    up-projects the whole cache), under the plan's body or, with
    ``invariant``, under ``ops.batch_invariant`` (prefill's)."""
    import contextlib
    gen = torch.Generator(device=dev).manual_seed(n + k + m + t_rows)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    v = (torch.randn(n, k, generator=gen, device=dev) / math.sqrt(n)
         ).to(dtype)
    u = (torch.randn(k, m, generator=gen, device=dev) / math.sqrt(k)
         ).to(dtype)
    with ops.batch_invariant() if invariant else contextlib.nullcontext():
        want = ops.lowrank_matmul(x, v, u)
        t = ops.lowrank_down(x, v)
        got = ops.lowrank_up(t, u)
        cache = torch.cat([t, torch.randn(t_rows, k, generator=gen,
                                          device=dev).to(dtype)])
        got_cache = ops.lowrank_up(cache, u)[:t_rows]
    same = torch.equal(got, want)
    same_cache = torch.equal(got_cache, want)
    require(same and (same_cache or not invariant),
            f"lowrank_up {t_rows}x{k}x{m} {dtype} invariant={invariant}: "
            f"differs from lowrank_matmul's t @ U (same T {same}, on a "
            f"{2 * t_rows}-row cache {same_cache})")
    return {"shape": [t_rows, n, k, m], "dtype": str(dtype).replace(
        "torch.", ""), "batch_invariant": invariant, "bitwise_equal": same,
        "bitwise_equal_in_cache": same_cache,
        "max_abs_err": float((got.float() - want.float()).abs().max())}


def phase_kernels(torch, ops, ref, dev="cuda", sizes=SIZES):
    return (phase_cov(torch, ops, ref, dev, sizes),
            phase_lowrank(torch, ops, ref, dev, sizes))


def phase_lowrank(torch, ops, ref, dev="cuda", sizes=SIZES):
    """lowrank_matmul at each llama and deepseek shape and T of
    ``lowrank_T`` (fp32 and bf16, with and without the epilogue; timed in
    bf16 without it), ragged
    T at the first llama shape and at the ragged (n, k, m), then each bf16
    body forced at the T of ``lowrank_forced_T`` it takes (two llama shapes
    and the ragged one: prefill takes the wgmma body at any T)."""
    from repro_torch.kernels import lowrank_matmul as low
    rows = []

    def add(*args, **kw):
        row = check_lowrank(torch, ops, ref, *args, dev=dev, **kw)
        rows.append(row)
        log("lowrank_matmul", json.dumps(row))

    shapes = sizes["lowrank_nkm"]
    dtypes = (torch.float32, torch.bfloat16)
    for n, k, m in shapes[:-1]:
        for t_rows in sizes["lowrank_T"]:
            for dtype in dtypes:
                for epilogue in (False, True):
                    add(t_rows, n, k, m, dtype, epilogue,
                        dtype == torch.bfloat16 and not epilogue)
    per_shape = [((n, k, m), sizes["lowrank_T"]) for n, k, m in (
        sizes["lowrank_nkm_moe"] + sizes.get("lowrank_nkm_kimi", ()))]
    for (n, k, m), t_list in per_shape + list(sizes.get("lowrank_nkm_ssm",
                                                        ())):
        for t_rows in t_list:
            for dtype in dtypes:
                for epilogue in (False, True):
                    add(t_rows, n, k, m, dtype, epilogue,
                        dtype == torch.bfloat16 and not epilogue)
    n, k, m = shapes[0]
    for t_rows in sizes["lowrank_ragged_T"]:
        for dtype in dtypes:
            add(t_rows, n, k, m, dtype, True, False)
    n, k, m = shapes[-1]
    for t_rows in sizes["lowrank_ragged_T"] + (sizes["tokens"],):
        for dtype in dtypes:
            for epilogue in (False, True):
                add(t_rows, n, k, m, dtype, epilogue, False)
    small_max = low.SMALL_ROWS[torch.bfloat16][-1]
    for n, k, m in shapes[:2] + shapes[-1:]:
        for t_rows in sizes["lowrank_forced_T"]:
            for body in ("small_t", "wgmma"):
                if body == "wgmma" or t_rows <= small_max:
                    add(t_rows, n, k, m, torch.bfloat16, False, False,
                        body=body)
    # x @ V alone (the latent cache's projections), at the attention
    # shape's and the ragged shape's (n, k)
    for n, k, _ in shapes[:1] + shapes[-1:]:
        for t_rows in sizes["lowrank_ragged_T"] + (8, 256):
            for dtype in dtypes:
                for invariant in (False, True):
                    row = check_lowrank_down(torch, ops, t_rows, n, k, dtype,
                                             invariant, dev)
                    rows.append(row)
                    log("lowrank_down", json.dumps(row))
    # t @ U alone (the latent cache's up-projection in prefill) against
    # lowrank_matmul's own: the same bits
    for n, k, m in shapes[:1] + shapes[-1:]:
        for t_rows in (8, 77, 512):
            for dtype in dtypes:
                for invariant in (False, True):
                    row = check_lowrank_up(torch, ops, t_rows, n, k, m, dtype,
                                           invariant, dev)
                    rows.append(row)
                    log("lowrank_up", json.dumps(row))
    return rows


def ptxas_usage(text):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from nvcc's ``-Xptxas -v`` output."""
    import re
    usage, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, [0, 0, 0])
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                usage[fn][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[fn][0] = int(m.group(1))
    return {fn: tuple(u) for fn, u in usage.items()}


def sass_report(lib_path):
    """{kernel symbol: HGMMA instruction count} from ``cuobjdump
    --dump-sass`` of the built library, or None without cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return None
    out = subprocess.run([tool, "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def _spread(np, spec, n):
    """``n`` integers spread evenly over (lo, hi), or ``spec`` n times."""
    if isinstance(spec, tuple):
        return np.linspace(spec[0], spec[1], n).astype(np.int64).tolist()
    return [spec] * n


def _live_keys(q_pos, lk, causal, window):
    """(live key count, first key, last key) of one query row."""
    hi = min(q_pos, lk - 1) if causal else lk - 1
    lo = max(0, q_pos - window + 1) if window else 0
    return max(0, hi - lo + 1), lo, hi


def _flash_inputs(torch, np, case, dtype, dev):
    """(q, k, v, offsets, kwargs of flash_attention) of a case."""
    name, b, h, kv, lq, lk, d, causal, window, softcap, off = case
    gen = torch.Generator(device=dev).manual_seed(lq + lk + d)
    q = torch.randn(b, lq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, lk, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, lk, kv, d, generator=gen, device=dev).to(dtype)
    offs = _spread(np, off, b)
    q_offset = (torch.tensor(offs, dtype=torch.int32, device=dev)
                if isinstance(off, tuple) else off)
    return q, k, v, offs, dict(causal=causal, window=window,
                               q_offset=q_offset, softcap=softcap)


def _launched_plans(fa, fn):
    """(fn's result, the plans ``fa.launch`` received during it from the
    wrapper: an autotuner measurement's launches are not the call's)."""
    from repro_torch.kernels import autotune
    plans, launch = [], fa.launch

    def spy(p, *args, **kw):
        if not autotune.measuring():
            plans.append(p)
        return launch(p, *args, **kw)

    fa.launch = spy
    try:
        return fn(), plans
    finally:
        fa.launch = launch


def check_flash_attention(torch, np, ops, ref, case, dtype, timed, dev):
    from repro_torch.kernels import flash_attention as fa
    name, b, h, kv, lq, lk, d, causal, window, softcap, off = case
    q, k, v, offs, kw = _flash_inputs(torch, np, case, dtype, dev)
    want = ref.flash_attention_ref(q, k, v, **kw)
    got, plans = _launched_plans(fa, lambda: ops.flash_attention(q, k, v,
                                                                 **kw))
    # the plan the wrapper launched, at the head dim it passed: the
    # caller's own where it is compiled (96 and 112 among them)
    dk = ops._padded_head_dim(d)
    if dev != "cpu":
        require(len(plans) == 1 and plans[0].d == dk,
                f"flash_attention {name}: launched "
                f"{[(p.body, p.d) for p in plans]}, want one at d {dk}")
    p = plans[0] if plans else fa.plan(b, lq, lk, h, kv, dk, dtype,
                                       causal=causal, window=window)
    # one-token GQA decode in bf16 takes the tensor-core body
    if lq == 1 and h > kv and dk >= 64 and dtype == torch.bfloat16:
        require(p.body == "split_mma", f"flash_attention {name}: GQA "
                f"decode launched {p.body}, want split_mma")
    err = rel_fro(got, want)
    mae = float((got.float() - want.float()).abs().max())
    # fp32: the same fp32 arithmetic in another order (and the card's own
    # exp / tanh): 1e-5 relative Frobenius.  bf16: the output rounds to
    # bf16 (2^-8 relative) and p rounds to bf16 before PV in both, where a
    # score an ulp apart can round p the other way: 1e-2
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    require(err <= lim, f"flash_attention {name} {dtype}: rel err "
            f"{err:.3e} > {lim:.0e}")
    row = {"case": name, "shape": [b, h, kv, lq, lk, d],
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "window": window, "softcap": softcap, "q_offset": offs,
           "body": p.body, "kernel_d": p.d, "bkey": p.bkey, "spans": p.spans,
           "rel_fro_err": err, "max_abs_err": mae,
           # the output's bits, to hold two builds of the kernel to each
           # other on the same seeded inputs
           "out_sha256": hashlib.sha256(
               got.float().cpu().numpy().tobytes()).hexdigest()[:16]}
    if timed:
        row["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        row["device_ms"] = device_ms(lambda: ops.flash_attention(q, k, v,
                                                                 **kw))
        # the call's launches apart (a split call's span body and merge),
        # each one's device time by torch.profiler
        row["kernels_device_ms"] = kernel_ms(
            lambda: ops.flash_attention(q, k, v, **kw))
        row["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                                  **kw))
        # yardstick: scaled_dot_product_attention on the same inputs in its
        # (B, H, L, D) layout, the masks as a boolean mask (never called by
        # the port; it has no soft cap)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qpos = (torch.tensor(offs, device=dev)[:, None, None, None]
                + torch.arange(lq, device=dev)[:, None])
        kpos = torch.arange(lk, device=dev)
        mask = torch.ones_like(qpos + kpos, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # grouped-query heads through enable_gqa (gemma3: 4 on 1)
        gqa = {} if kv == h else {"enable_gqa": True}
        masked = None if softcap else (
            lambda: sdpa(qt, kt, vt, attn_mask=mask, **gqa))
        if not causal and not window and not softcap:
            # nothing is masked (whisper's encoder and cross-attention):
            # SDPA without a mask
            def masked():
                return sdpa(qt, kt, vt, **gqa)
        row["library_ms"] = None if masked is None else time_ms(masked)
        row["library_device_ms"] = (None if masked is None
                                    else device_ms(masked))
        # a second yardstick where the mask is plain causal at offset 0:
        # is_causal may reach SDPA's flash backend, a boolean mask may not
        # (a window as long as Lk masks nothing more)
        plain_causal = (causal and (not window or window >= lk)
                        and not softcap and lq == lk and not any(offs))
        row["library_causal_ms"] = row["library_causal_device_ms"] = None
        if plain_causal:
            def causal_call():
                return sdpa(qt, kt, vt, is_causal=True, **gqa)
            row["library_causal_ms"] = time_ms(causal_call)
            row["library_causal_device_ms"] = device_ms(causal_call)
        eb = q.element_size()
        live = keys = 0
        for o in offs:
            spans = [_live_keys(o + i, lk, causal, window) for i in range(lq)]
            live += sum(sp[0] for sp in spans)
            keys += (max(sp[2] for sp in spans)
                     - min(sp[1] for sp in spans) + 1)
        flops = 4 * h * d * live
        nbytes = (2 * b * lq * h * d + 2 * keys * kv * d) * eb
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
    return row


def check_flash_rows(torch, np, ops, case, chunks, dev):
    """The prefill case's rows computed again inside chunks of Lq rows (at
    each chunk's own offset, against the same keys), under
    batch_invariant: every row gives the same bits as in the whole call
    (bf16; the tile bodies walk key tiles from absolute key 0)."""
    name, b, h, kv, lq, lk, d, causal, window, softcap, off = case
    q, k, v, offs, kw = _flash_inputs(torch, np, case, torch.bfloat16, dev)
    with ops.batch_invariant():
        whole = ops.flash_attention(q, k, v, **kw)
        rows = []
        for n, starts in chunks:
            for c0 in starts:
                part = ops.flash_attention(q[:, c0:c0 + n].contiguous(), k,
                                           v, **{**kw, "q_offset": c0})
                rows.append({"rows": n, "first": c0, "bitwise_equal":
                             torch.equal(part, whole[:, c0:c0 + n])})
    row = {"case": name, "shape": [b, h, kv, lq, lk, d], "dtype": "bfloat16",
           "chunks": rows}
    bad = [(r["rows"], r["first"]) for r in rows if not r["bitwise_equal"]]
    require(not bad, f"flash_attention {name}: rows differ when computed "
            f"inside chunks (rows, first row) {bad}")
    return row


def check_flash_split_repeat(torch, np, ops, case, dtype, dev):
    """Two calls of the split body (Lq 1) on the same inputs give the same
    bits: its span partials are merged in span order, no atomics."""
    q, k, v, offs, kw = _flash_inputs(torch, np, case, dtype, dev)
    first = ops.flash_attention(q, k, v, **kw)
    second = ops.flash_attention(q, k, v, **kw)
    same = torch.equal(first, second)
    require(same, f"flash_attention {case[0]} {dtype}: two split-body calls "
            "differ")
    return {"case": case[0], "dtype": str(dtype).replace("torch.", ""),
            "repeat_bitwise_equal": same}


def check_flash_kernels(torch, np, ops, case, dev):
    """The device work of a bf16 call (5 profiled, each kernel's device ms
    a call), by ``torch.profiler``: a split call's span kernel
    (``flash_split<`` for split, ``flash_split_mma<`` for split_mma) and
    ``flash_merge`` alone, a wgmma call's ``flash_wgmma<`` alone; the
    inputs read in place (no pad, copy, slice or memset on the device)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, offs, kw = _flash_inputs(torch, np, case, torch.bfloat16, dev)
    row = {"case": case[0], "shape": list(case[1:7]), "dtype": "bfloat16"}
    if dev == "cpu":
        return {**row, "device_work": None}
    # the plan cached, the build done
    _, plans = _launched_plans(fa, lambda: ops.flash_attention(q, k, v,
                                                               **kw))
    torch.cuda.synchronize()
    require(len(plans) == 1 and plans[0].body in ("wgmma",) + fa.SPLIT_BODIES,
            f"flash_attention {case[0]}: launched "
            f"{[p.body for p in plans]}, want one split or wgmma call")
    if plans[0].spans:
        want = (f"{plans[0].body.replace('split', 'flash_split')}<",
                "flash_merge<")
    else:
        want = ("flash_wgmma<",)
    from torch.profiler import ProfilerActivity, profile
    calls = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    work = {n: ms / calls for n, ms in device_times(prof).items()}
    names = sorted(work)
    require(any(want[0] in n for n in names)
            and all(any(w in n for w in want) for n in names),
            f"flash_attention {case[0]}: device work {names}, want "
            f"{' and '.join(want)} alone")
    return {**row, "body": plans[0].body,
            "device_work": {n[:80]: ms for n, ms in work.items()}}


def _bwd_bound(case, dtype_name):
    """The least time any backward takes for a case: 2.5x the forward's
    products (10·H·D flops a live (query, key) pair: S, dP, dV, dQ, dK;
    not the recompute this design adds) and q, k, v, o, dO read once, dq,
    dk, dv written once."""
    import numpy as np
    name, b, h, kv, lq, lk, d, causal, window, softcap, off = case
    live = keys = 0
    for o in _spread(np, off, b):
        spans = [_live_keys(o + i, lk, causal, window) for i in range(lq)]
        live += sum(sp[0] for sp in spans)
        keys += max(sp[2] for sp in spans) - min(sp[1] for sp in spans) + 1
    eb = 4 if dtype_name == "float32" else 2
    flops = 10 * h * d * live
    nbytes = (4 * b * lq * h * d + 4 * keys * kv * d) * eb
    return bound(flops, nbytes, dtype_name)


def check_flash_backward(torch, np, ops, ref, case, dtype, timed, dev):
    """The backward kernel (``csrc/flash_attention_bwd.cu``) on a case:
    (dq, dk, dv) against the plain backward (``ref.flash_attention_bwd_ref``,
    the fp32 einsum scan recomputed and differentiated) — rel Frobenius 2e-5
    in fp32 (the contracts' fp32 attention tolerance), 2e-2 in bf16 (every
    operand and gradient is bf16; both round P, the plain also dP) —, two
    launches bit for bit equal, and the forward's output bit for bit the
    same with and without the LSE it writes for the backward.  Timed: the
    kernel (``ms``, and ``device_ms`` with the L2 cold), the plain backward,
    SDPA's backward alone (``_sdpa_backward``), the bound."""
    name, b, h, kv, lq, lk, d, causal, window, softcap, off = case
    q, k, v, offs, kw = _flash_inputs(torch, np, case, dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(lq + 2 * lk + d)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    plain_bwd = PLAIN_BWD["fn"] or ref.flash_attention_bwd_ref
    want = plain_bwd(q, k, v, dout, **kw)
    plain_out = ops.flash_attention(q, k, v, **kw)
    out, lse = ops.flash_attention_lse(q, k, v, **kw)
    fwd_same = bool(torch.equal(out, plain_out))
    first = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    repeat = all(torch.equal(x, y) for x, y in zip(first, second))
    errs = [rel_fro(g, w) for g, w in zip(first, want)]
    maes = [float((g.float() - w.float()).abs().max()) for g, w in
            zip(first, want)]
    tops = [float(w.float().abs().max()) for w in want]
    finite = all(bool(torch.isfinite(g).all()) for g in first)
    dname = str(dtype).replace("torch.", "")
    p = None
    if dev != "cpu":
        from repro_torch.kernels import autotune
        p = autotune.flash_bwd_plan(b, lq, lk, h, kv, ops._padded_head_dim(d),
                                    dtype, causal=causal, window=window,
                                    device=q.device).plan
    row = {"case": name, "shape": [b, h, kv, lq, lk, d], "dtype": dname,
           "causal": causal, "window": window, "softcap": softcap,
           "q_offset": offs, "body": p.body if p else None,
           "kernel_d": p.d if p else None,
           "rel_fro_err": errs, "max_abs_err": max(maes),
           "max_abs_over_max_ref": max(m / max(t, 1e-30)
                                       for m, t in zip(maes, tops)),
           "repeat_bitwise_equal": repeat, "forward_bitwise_with_lse":
           fwd_same, "finite": finite,
           "grads_sha256": hashlib.sha256(b"".join(
               g.float().cpu().numpy().tobytes() for g in first)
           ).hexdigest()[:16]}
    lim = 2e-5 if dtype == torch.float32 else 2e-2
    require(finite, f"flash_attention_bwd {name} {dname}: non-finite grads")
    require(max(errs) <= lim, f"flash_attention_bwd {name} {dname}: rel "
            f"err {errs} > {lim:.0e}")
    require(repeat, f"flash_attention_bwd {name} {dname}: two launches "
            "differ")
    require(fwd_same, f"flash_attention {name} {dname}: the output with "
            "the LSE written differs from the output without")
    if timed:
        def run():
            return ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        row["ms"] = time_ms(run)
        row["device_ms"] = device_ms(run)
        row["kernels_device_ms"] = kernel_ms(run)
        row["plain_ms"] = time_ms(lambda: plain_bwd(q, k, v, dout, **kw),
                                  warmup=1, reps=3)
        lib = _sdpa_backward(torch, q, k, v, dout, offs, case)
        row["library_ms"] = None if lib is None else time_ms(lib)
        # autograd's engine syncs with the forward's stream, which a CUDA
        # graph's capture refuses, so SDPA's backward gets no device_ms:
        # its launches' device time by torch.profiler instead (beside the
        # kernel's kernels_device_ms; neither counts the gaps)
        lib_k = None if lib is None else kernel_ms(lib)
        row["library_kernels_device_ms"] = lib_k
        row["library_device_ms"] = (None if lib_k is None
                                    else sum(lib_k.values()))
        row["bound_ms"], row["bound_by"] = _bwd_bound(case, dname)
    return row


def _sdpa_backward(torch, q, k, v, dout, offs, case):
    """SDPA's backward alone on a case's inputs, or None where SDPA cannot
    compute the function (a soft cap, or a row with no live key, which a
    boolean mask turns to NaN): ``scaled_dot_product_attention`` run once
    in its (B, H, L, D) layout with its graph kept, then a call that is
    ``autograd.grad`` of that output — SDPA's own backward kernel.
    ``is_causal`` where the mask is plain causal at offset 0 with Lq == Lk
    (SDPA's flash backend), no mask where nothing is masked, else the
    case's boolean mask.  Timed only, never called by the port."""
    name, b, h, kv, lq, lk, d, causal, window, softcap, off = case
    if softcap or any(_live_keys(o + i, lk, causal, window)[0] == 0
                      for o in offs for i in range(lq)):
        return None
    dev = q.device
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()
    kw = {} if kv == h else {"enable_gqa": True}
    if causal and (not window or window >= lk) and lq == lk and not any(offs):
        kw["is_causal"] = True
    elif causal or window:
        qpos = (torch.tensor(offs, device=dev)[:, None, None, None]
                + torch.arange(lq, device=dev)[:, None])
        kpos = torch.arange(lk, device=dev)
        mask = torch.ones_like(qpos + kpos, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        kw["attn_mask"] = mask
    out = sdpa(qt, kt, vt, **kw)

    def run():
        return torch.autograd.grad(out, (qt, kt, vt), dt, retain_graph=True)
    return run


# The plain backward as chip_smoke.py calls it on purpose (phase 3's and 15
# (e)'s comparisons); ``count_plain_backward`` puts a counter in its place
# for every other caller: it must read 0 on CUDA tensors in phases 4-16
PLAIN_BWD = {"fn": None, "cuda_calls": 0}


def count_plain_backward(ref):
    """From here on, count every call of ``ref.flash_attention_bwd_ref`` on
    CUDA tensors that does not come from this script's own comparisons."""
    if PLAIN_BWD["fn"] is not None:
        return
    plain = PLAIN_BWD["fn"] = ref.flash_attention_bwd_ref

    def counted(q, *args, **kw):
        if q.device.type == "cuda":
            PLAIN_BWD["cuda_calls"] += 1
        return plain(q, *args, **kw)

    ref.flash_attention_bwd_ref = counted


def phase_flash_attention(torch, np, ops, ref, dev="cuda", sizes=SIZES):
    """flash_attention's rows (every case in fp32 and bf16, the main paths'
    timed in bf16; then ragged cases through the split and wgmma bodies),
    then its bitwise checks: rows invariant under chunking, and two split
    calls equal; then the profiled calls' device work; then the backward's
    rows (every case with Lq > 1 and the rows-that-see-no-key cases in
    fp32 and bf16, the main paths' timed in bf16)."""
    rows, checks = [], []
    extra = sizes["flash_attention_ragged"]
    for case in sizes["flash_attention"] + extra:
        for dtype in (torch.float32, torch.bfloat16):
            timed = (case in sizes["flash_attention"] and case[0] != "ragged"
                     and dtype == torch.bfloat16)
            row = check_flash_attention(torch, np, ops, ref, case, dtype,
                                        timed, dev)
            rows.append(row)
            log("flash_attention", json.dumps(row))
    for name in sizes["flash_attention_rows_cases"]:
        case = next(c for c in sizes["flash_attention"] if c[0] == name)
        checks.append(check_flash_rows(torch, np, ops, case,
                                       sizes["flash_attention_rows"], dev))
        log("flash_attention rows", json.dumps(checks[-1]))
    split_cases = [c for c in sizes["flash_attention"] + extra if c[4] == 1]
    for case in split_cases:
        for dtype in (torch.float32, torch.bfloat16):
            checks.append(check_flash_split_repeat(torch, np, ops, case,
                                                   dtype, dev))
            log("flash_attention repeat", json.dumps(checks[-1]))
    profiled = [c for c in sizes["flash_attention"]
                if c[0] in sizes["flash_attention_profiled"]]
    for case in profiled:
        checks.append(check_flash_kernels(torch, np, ops, case, dev))
        log("flash_attention device work", json.dumps(checks[-1]))
    for case in (sizes["flash_attention"] + extra
                 + sizes["flash_attention_bwd_dead"]):
        if case[4] == 1:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            timed = (case in sizes["flash_attention"] and case[0] != "ragged"
                     and dtype == torch.bfloat16)
            row = check_flash_backward(torch, np, ops, ref, case, dtype,
                                       timed, dev)
            checks.append({**row, "kernel": "flash_attention_bwd"})
            log("flash_attention_bwd", json.dumps(row))
        if dev != "cpu":
            torch.cuda.empty_cache()
    return rows, checks


def _decode_inputs(torch, np, case, dtype, dev):
    """(q, lk, lv, uk, uv, lengths, cos, sin) and the lengths of a
    ``flash_decode`` case."""
    from repro_torch.models import layers as L
    name, b, h, kv, d, rk, rv, l, spread = case[:9]
    gen = torch.Generator(device=dev).manual_seed(rk + rv + l)
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    lk = torch.randn(b, l, rk, generator=gen, device=dev).to(dtype)
    lv = torch.randn(b, l, rv, generator=gen, device=dev).to(dtype)
    uk = torch.randn(rk, kv * d, generator=gen, device=dev) / math.sqrt(rk)
    uv = torch.randn(rv, kv * d, generator=gen, device=dev) / math.sqrt(rv)
    lens = _spread(np, spread, b)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    cos, sin = L.rope_table(torch.arange(l, device=dev), d, 10000.0)
    return (q, lk, lv, uk, uv, lengths, cos, sin), lens


def _rope(case):
    """A flash_decode case's rope flag (its 10th field; default True)."""
    return case[9] if len(case) > 9 else True


def check_flash_decode(torch, np, ops, ref, case, dtype, timed, dev):
    from repro_torch.kernels import flash_decode as fd
    name, b, h, kv, d, rk, rv, l, spread = case[:9]
    rope = _rope(case)
    args, lens = _decode_inputs(torch, np, case, dtype, dev)
    want = ref.flash_decode_ref(*args, rope=rope)
    got = ops.flash_decode(*args, rope=rope)
    err = rel_fro(got, want)
    mae = float((got.float() - want.float()).abs().max())
    # all arithmetic fp32 in both, summed in another order: 1e-5 relative
    # Frobenius; bf16 queries / latents give a bf16 output (2^-8): 5e-3
    lim = 1e-5 if dtype == torch.float32 else 5e-3
    require(err <= lim, f"flash_decode {name} {dtype}: rel err {err:.3e} "
            f"> {lim:.0e}")
    p = fd.plan(b, l, h, kv, d, rk, rv, dtype)
    row = {"case": name, "shape": [b, h, kv, d, rk, rv, l],
           "dtype": str(dtype).replace("torch.", ""), "lengths": lens,
           "rope": rope, "body": p.body, "work_items": len(p.items(lens)),
           "rel_fro_err": err, "max_abs_err": mae}
    if timed:
        def call():
            return ops.flash_decode(*args, rope=rope)

        row["ms"] = time_ms(call)
        row["device_ms"] = device_ms(call)
        row["kernels_device_ms"] = kernel_ms(call)
        row["plain_ms"] = time_ms(lambda: ref.flash_decode_ref(
            *args, rope=rope))
        # no single PyTorch call computes attention with in-kernel key
        # up-projection and latent-space values
        row["library_ms"] = None
        eb = args[0].element_size()
        live = sum(lens)
        up = fd.bound_flops(lens, rk, kv, d)
        rest = 2 * live * (h * d + h * rv) + 2 * b * h * rv * d
        nbytes = (live * (rk + rv) * eb + (rk + rv) * kv * d * 4
                  + 2 * b * h * d * eb)
        # the function is defined in fp32 arithmetic: the fp32 peak
        row["bound_ms"], row["bound_by"] = bound(up + rest, nbytes,
                                                 "float32")
        # the wgmma body's work: the up-projection as two bf16 terms on the
        # tensor cores, the rest on the FMA units (the larger of the two
        # and the bytes); none for the FMA body
        row["bound_tc_ms"] = row["bound_tc_by"] = None
        if p.body == "wgmma":
            tc_ms, tc_by = bound(2 * up, nbytes, "bfloat16")
            fma_ms = rest / PEAK_FLOPS["float32"] * 1e3
            row["bound_tc_ms"] = max(tc_ms, fma_ms)
            row["bound_tc_by"] = (tc_by if tc_ms >= fma_ms
                                  else "operations (FMA)")
    return row


def check_flash_decode_alone(torch, np, ops, case, dtype, dev):
    """Each slot computed alone (one slot, its cache cut to its own
    length) gives the bits of the same slot inside the batch: key spans
    start at absolute key 0 and a slot's spans merge in order, whatever B,
    L or the other slots."""
    args, lens = _decode_inputs(torch, np, case, dtype, dev)
    q, lk, lv, uk, uv, lengths, cos, sin = args
    rope = _rope(case)
    whole = ops.flash_decode(*args, rope=rope)
    same = []
    for bi, n in enumerate(lens):
        alone = ops.flash_decode(
            q[bi:bi + 1].contiguous(), lk[bi:bi + 1, :n].contiguous(),
            lv[bi:bi + 1, :n].contiguous(), uk, uv, lengths[bi:bi + 1],
            cos[:n].contiguous(), sin[:n].contiguous(), rope=rope)
        same.append(bool(torch.equal(alone[0], whole[bi])))
    row = {"case": case[0], "dtype": str(dtype).replace("torch.", ""),
           "lengths": lens, "alone_bitwise_equal": same}
    bad = [n for n, ok in zip(lens, same) if not ok]
    require(not bad, f"flash_decode {case[0]} {dtype}: slots of lengths "
            f"{bad} differ alone and inside the batch")
    return row


def phase_decode_kernels(torch, np, ops, ref, dev="cuda", sizes=SIZES):
    """flash_decode's rows (every case in fp32 and bf16, llama's and
    granite's timed), then each llama slot alone against the batch, bit
    for bit."""
    rows, checks = [], []
    for case in sizes["flash_decode"]:
        for dtype in (torch.float32, torch.bfloat16):
            row = check_flash_decode(torch, np, ops, ref, case, dtype,
                                     case[0] in sizes["flash_decode_timed"],
                                     dev)
            rows.append(row)
            log("flash_decode", json.dumps(row))
    for name in sizes.get("flash_decode_alone", ("llama",)):
        case = next(c for c in sizes["flash_decode"] if c[0] == name)
        for dtype in (torch.float32, torch.bfloat16):
            checks.append(check_flash_decode_alone(torch, np, ops, case,
                                                   dtype, dev))
            log("flash_decode alone", json.dumps(checks[-1]))
    return rows, checks


def phase_attention_kernels(torch, np, ops, ref, dev="cuda", sizes=SIZES):
    fa_rows, fa_checks = phase_flash_attention(torch, np, ops, ref, dev,
                                               sizes)
    fd_rows, fd_checks = phase_decode_kernels(torch, np, ops, ref, dev, sizes)
    return fa_rows, fd_rows, fa_checks, fd_checks


def _group_sizes(np, m, e, seed):
    """Skewed sizes summing to m (a Dirichlet(0.3) draw), experts 1 and
    e // 2 empty."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(e, 0.3))
    p[[1, e // 2]] = 0.0
    return rng.multinomial(m, p / p.sum())


def _grouped_mm_library(torch, x, w, gs):
    """``torch._grouped_mm`` on the same inputs (bf16 only, a yardstick the
    port never calls), or None with the reason."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    if x.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bf16 only"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        out = fn(x, w, offs=offs)
        torch.cuda.synchronize()
    except RuntimeError as exc:   # a yardstick only: report why, never fail
        return None, f"torch._grouped_mm refused: {str(exc)[:200]}"
    return (lambda: fn(x, w, offs=offs)), out


def _grouped_inputs(torch, np, case, dtype, dev, salt=0):
    """(sizes, group_sizes on the device, x, w) of a ``grouped`` case."""
    name, m, d, f, e = case
    sizes = _group_sizes(np, m, e, m + d + f + salt)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(m + d + f + salt)
    x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(e, d, f, generator=gen, device=dev) / math.sqrt(d)
         ).to(dtype)
    return sizes, gs, x, w, gen


def _tile_waste(gm, m, d, f, e, dtype, sizes):
    """The tail tiles' share of the wgmma body's row work: rows computed
    and not stored, over the rows stored (0 for the fp32 body)."""
    p = gm.plan(m, d, f, e, dtype)
    live = min(m, int(sizes.sum()))
    return (p.computed_rows(sizes.tolist()) - live) / max(live, 1) \
        if p.body == "wgmma" else 0.0


def check_grouped(torch, np, ops, ref, case, dtype, timed, dev):
    from repro_torch.kernels import grouped_matmul as gm
    name, m, d, f, e = case
    sizes, gs, x, w, _ = _grouped_inputs(torch, np, case, dtype, dev)
    want = ref.grouped_matmul_ref(x, w, gs)
    got = ops.grouped_matmul(x, w, gs)
    err = rel_fro(got, want)
    mae = float((got.float() - want.float()).abs().max())
    # fp32 (FMA units): the same fp32 products summed in another order:
    # 1e-5.  bf16 (tensor cores): exact products, fp32 accumulation, the
    # output rounded to bf16 (2^-8 relative): 1e-2
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    require(tuple(got.shape) == (m, f) and got.dtype == dtype,
            f"grouped_matmul {name}: {tuple(got.shape)} {got.dtype}")
    require(err <= lim, f"grouped_matmul {name} {dtype}: rel err {err:.3e} "
            f"> {lim:.0e}")
    row = {"case": name, "shape": [m, d, f, e],
           "dtype": str(dtype).replace("torch.", ""),
           "empty_experts": int((sizes == 0).sum()),
           "largest_group": int(sizes.max()), "rel_fro_err": err,
           "max_abs_err": mae,
           "tile_waste": _tile_waste(gm, m, d, f, e, dtype, sizes)}
    if timed:
        row["ms"] = time_ms(lambda: ops.grouped_matmul(x, w, gs))
        row["device_ms"] = device_ms(lambda: ops.grouped_matmul(x, w, gs))
        row["plain_ms"] = time_ms(lambda: ref.grouped_matmul_ref(x, w, gs))
        lib, out = _grouped_mm_library(torch, x, w, gs)
        row["library_ms"] = None if lib is None else time_ms(lib)
        if lib is None:
            row["library_note"] = out
        else:
            row["library_rel_err"] = rel_fro(out, want)
            row["library_device_ms"] = device_ms(lib)
        eb = x.element_size()
        live = int((sizes > 0).sum())       # experts whose weights are read
        flops = 2 * m * d * f
        nbytes = (m * d + live * d * f + m * f) * eb
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, row["dtype"])
    return row


def check_grouped_backward(torch, np, ops, ref, case, dtype, timed, dev):
    """dx (the kernel reading W[g]ᵀ in place, bf16; on Wᵀ made contiguous,
    fp32) and dW (per-segment products) against autograd through the plain
    version, on the same inputs and cotangent; timed: one backward (dx and
    dW) between CUDA events beside autograd through the plain version, and
    dx alone beside ``torch._grouped_mm`` on dy and W[g]ᵀ."""
    name, m, d, f, e = case
    sizes, gs, x0, w0, gen = _grouped_inputs(torch, np, case, dtype, dev,
                                             salt=1)
    dy = torch.randn(m, f, generator=gen, device=dev).to(dtype)
    grads = []
    fns = (lambda a, b: ops.grouped_matmul(a, b, gs),
           lambda a, b: ref.grouped_matmul_ref(a, b, gs).to(dtype))
    for fn in fns:
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x, w), (x, w), dy))
    errs = [rel_fro(g, r) for g, r in zip(*grads)]
    # as the forward: fp32 1e-5; bf16 1e-2 (dx rounds to bf16 in both)
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    require(max(errs) <= lim, f"grouped_matmul backward {name} {dtype}: rel "
            f"err dx {errs[0]:.3e} dW {errs[1]:.3e} > {lim:.0e}")
    row = {"case": name, "shape": [m, d, f, e],
           "dtype": str(dtype).replace("torch.", ""), "dx_rel_fro_err":
           errs[0], "dw_rel_fro_err": errs[1], "max_abs_err": max(
               float((g.float() - r.float()).abs().max())
               for g, r in zip(*grads))}
    if timed:
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        outs = [fn(x, w) for fn in fns]
        row["ms"] = time_ms(lambda: torch.autograd.grad(
            outs[0], (x, w), dy, retain_graph=True))
        row["plain_ms"] = time_ms(lambda: torch.autograd.grad(
            outs[1], (x, w), dy, retain_graph=True))
        # dx alone: the kernel reading W[g]ᵀ in place, and the one PyTorch
        # call that computes it (no single call computes dx and dW)
        row["dx_ms"] = time_ms(lambda: ops._grouped_kernel(dy, w0, gs,
                                                           trans=True))
        row["library_ms"] = None
        lib, out = _grouped_mm_library(torch, dy, w0.transpose(1, 2), gs)
        row["library_dx_ms"] = None if lib is None else time_ms(lib)
        if lib is None:
            row["library_note"] = out
        # dW alone: torch._grouped_mm's 2-D x 2-D form, xᵀ (d, M) by dy
        # (M, f) with offs grouping the contraction M, gives (E, d, f) in
        # one call
        lib, out = _grouped_mm_library(torch, x0.t(), dy, gs)
        row["library_dw_ms"] = None if lib is None else time_ms(lib)
        if lib is None:
            row["library_dw_note"] = out
        else:
            row["library_dw_rel_err"] = rel_fro(out, grads[1][1])
        live = int((sizes > 0).sum())
        eb = x0.element_size()
        # dx and dW: 4·M·d·f flops; dy, W, x read, dx and dW written
        nbytes = (m * f + live * d * f + 2 * m * d + e * d * f) * eb
        row["bound_ms"], row["bound_by"] = bound(4 * m * d * f, nbytes,
                                                 row["dtype"])
    return row


def check_grouped_shift(torch, np, ops, case, dev):
    """The same rows run again behind extra rows of other experts: before
    each expert's segment an extra expert with 0-199 rows of its own, so
    every segment's offset moves (by amounts that are not multiples of the
    row tile).  Each original row's output (and, through autograd, its dx)
    must be the same bits: a row's result depends only on the row and its
    expert's weights (bf16)."""
    name, m, d, f, e = case
    dtype = torch.bfloat16
    sizes, gs, x, w, gen = _grouped_inputs(torch, np, case, dtype, dev,
                                           salt=2)
    extra = np.random.default_rng(m + e).integers(0, 200, e)
    sizes2 = np.stack([extra, sizes], 1).reshape(-1)     # extra, own, ...
    gs2 = torch.tensor(sizes2, dtype=torch.int32, device=dev)
    w2 = torch.stack([torch.randn(e, d, f, generator=gen, device=dev).to(
        dtype), w], 1).reshape(2 * e, d, f)
    pieces, own = [], []
    start = pos = 0
    for g in range(e):
        pieces.append(torch.randn(int(extra[g]), d, generator=gen,
                                  device=dev).to(dtype))
        pos += int(extra[g])
        pieces.append(x[start:start + int(sizes[g])])
        own.append(torch.arange(pos, pos + int(sizes[g]), device=dev))
        start += int(sizes[g])
        pos += int(sizes[g])
    x2 = torch.cat(pieces)
    own = torch.cat(own)
    dy = torch.randn(m, f, generator=gen, device=dev).to(dtype)
    dy2 = torch.randn(x2.shape[0], f, generator=gen, device=dev).to(dtype)
    dy2[own] = dy
    outs = []
    for xi, wi, gi, dyi in ((x, w, gs, dy), (x2, w2, gs2, dy2)):
        xi = xi.clone().requires_grad_(True)
        y = ops.grouped_matmul(xi, wi, gi)
        dx, = torch.autograd.grad(y, (xi,), dyi)
        outs.append((y.detach(), dx))
    same_y = torch.equal(outs[0][0], outs[1][0][own])
    same_dx = torch.equal(outs[0][1], outs[1][1][own])
    row = {"case": name, "shape": [m, d, f, e], "dtype": "bfloat16",
           "extra_rows": int(extra.sum()), "y_bitwise_equal": same_y,
           "dx_bitwise_equal": same_dx}
    require(same_y and same_dx, f"grouped_matmul {name}: rows differ when "
            f"their segments move (y {same_y}, dx {same_dx})")
    return row


def phase_grouped_kernels(torch, np, ops, ref, dev="cuda", sizes=SIZES):
    rows = []
    for case in sizes["grouped"]:
        for dtype in (torch.float32, torch.bfloat16):
            timed = (not case[0].startswith("ragged")
                     and dtype == torch.bfloat16)
            row = check_grouped(torch, np, ops, ref, case, dtype, timed, dev)
            rows.append(row)
            log("grouped_matmul", json.dumps(row))
    back = []
    # a shape refinement differentiates (x @ V of the factorized gate/up
    # bank; bf16 timed) and the ragged one
    for case in (sizes["grouped"][2], sizes["grouped"][-1]):
        for dtype in (torch.float32, torch.bfloat16):
            timed = case[0] != "ragged" and dtype == torch.bfloat16
            row = check_grouped_backward(torch, np, ops, ref, case, dtype,
                                         timed, dev)
            back.append(row)
            log("grouped_matmul backward", json.dumps(row))
    by_name = {c[0]: c for c in sizes["grouped"]}
    for name in sizes["grouped_shift"]:
        row = check_grouped_shift(torch, np, ops, by_name[name], dev)
        back.append(row)
        log("grouped_matmul shift", json.dumps(row))
    return rows, back


# ---------------------------------------------------------------------------
# phase 4: smoke recipe on the card against the CPU


def _factor_pairs(tree, path=""):
    """(path, {"v", "u"}) of every factorized linear of a param tree, in
    order."""
    if isinstance(tree, dict):
        if "u" in tree and "v" in tree:
            return [(path, tree)]
        return [f for key in sorted(tree)
                for f in _factor_pairs(tree[key], f"{path}.{key}")]
    if isinstance(tree, (list, tuple)):
        return [f for i, item in enumerate(tree)
                for f in _factor_pairs(item, f"{path}[{i}]")]
    return []


def phase_smoke(torch, np, dev="cuda", arch="llama-7b", calib_shape=(8, 32)):
    """A dense-attention or SSM / hybrid arch's smoke config compressed on
    the card and on the CPU from the same params and ``calib_shape``
    uniform tokens (ranks, unit names and ``reused`` entries equal, every
    composed map, a weight-shared block's included, and the loss held to
    stated tolerances), then served on both (``phase_smoke_serve``)."""
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.models import model as M

    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    # 8 x 32 uniform tokens or more: every tap covariance has full rank, so
    # the solve is well conditioned and the two devices must agree closely
    calib = {"tokens": rng.integers(0, cfg.vocab_size, calib_shape)}
    t = rng.integers(0, cfg.vocab_size, (8, 65))
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])}
    recipe = P.CompressConfig(ratio=0.6, rank_multiple=1, microbatch=2,
                              calib_mode="fused", refine_epochs=1)
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        comp, rep = P.compress_model(params, cfg, calib, recipe, device=d)
        with torch.no_grad():
            loss = float(M.loss_fn(comp, cfg, {k: v.to(d)
                                               for k, v in batch.items()})[0])
        out[name] = (comp, rep, loss)
    ranks = {run: [[lin["rank"] for lin in u.get("linears", [])]
                   for u in out[run][1]["units"]] for run in ("card", "cpu")}
    require(ranks["card"] == ranks["cpu"], f"smoke {arch}: ranks differ "
            f"card {ranks['card']} cpu {ranks['cpu']}")
    units = {run: [(u["name"], u.get("reused", False), u["tapped_forwards"])
                   for u in out[run][1]["units"]] for run in ("card", "cpu")}
    require(units["card"] == units["cpu"], f"smoke {arch}: units differ "
            f"card {units['card']} cpu {units['cpu']}")
    worst, where = 0.0, None
    pairs = [_factor_pairs({"stages": out[run][0]["stages"],
                            "shared": out[run][0].get("shared")})
             for run in ("card", "cpu")]
    require(len(pairs[0]) == len(pairs[1]) > 0,
            f"smoke {arch}: factorized linears {len(pairs[0])} / "
            f"{len(pairs[1])}")
    for (path, a), (_, b) in zip(*pairs):
        maps = [torch.einsum("...nk,...km->...nm", lin["v"].cpu(),
                             lin["u"].cpu()).reshape(
                                 -1, lin["v"].shape[-2], lin["u"].shape[-1])
                for lin in (a, b)]
        for layer in range(maps[0].shape[0]):
            err = rel_fro(maps[0][layer], maps[1][layer])
            if err > worst:
                worst, where = err, f"{path} [{layer}]"
    lc, lp = out["card"][2], out["cpu"][2]
    tag = "smoke" if arch == "llama-7b" else f"smoke {arch}"
    reused = [u for u in out["card"][1]["units"] if u.get("reused")]
    log(f"{tag}: composed-map rel err (card vs cpu) {worst:.3e} at {where} "
        f"({calib_shape[0]} x {calib_shape[1]} tokens); loss card {lc:.6f} "
        f"cpu {lp:.6f}; ranks {ranks['card'][0]}; units "
        f"{[n for n, _, _ in units['card']]}; reused {json.dumps(reused)}")
    require(worst <= 1e-3, f"{tag} composed maps differ by {worst:.3e}")
    require(abs(lc / lp - 1) <= 1e-3, f"{tag} loss {lc} vs {lp}")
    if cfg.family == "hybrid":
        require(len(reused) == 1 and reused[0]["tapped_forwards"] == 0
                and "dec.shared.shared_attn" in [n for n, _, _
                                                 in units["card"]],
                f"{tag}: the shared block's units {units['card']}")
    served = phase_smoke_serve(torch, np, cfg, out["cpu"][0], dev)
    return {"map_rel_err": worst, "loss_cuda": lc, "loss_cpu": lp,
            "ranks": ranks["card"][0], "units": units["card"],
            "reused": reused, "serve": served}


def phase_smoke_serve(torch, np, cfg, comp, dev):
    """A compressed smoke model (fp32; llama, granite and phi3-medium over
    the latent cache, qwen3 over the dense one, gemma3 over its ring and
    dense caches, deepseek over MLA's {"c", "kr"} cache under ``cfg``'s
    dispatch) served on the card (kernels) and on the CPU (plain versions)
    from the same params and prompts: the engine (3 requests on 2 slots,
    chunk 8 and chunk 0; gemma3's ring caches take exact-length whole
    prefill either way) and ``Server`` (3 prompts on 4 slots); tokens
    equal, teacher-forced logits held to a stated tolerance.  Prompts of
    13-24 tokens run past gemma3's smoke window of 8, so its rings wrap.
    The SSM / hybrid archs take exact-length whole prefill; zamba2's engine
    also runs over the dense cache (its shared sites' {"k", "v"})."""
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, 24), dtype=np.int32)
    lens = (5, 21, 13)
    toks, logits = {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        runs = {}
        engines = [(f"engine_chunk{chunk}", chunk, "auto")
                   for chunk in (8, 0)]
        if cfg.family == "hybrid":
            engines.append(("engine_dense", 0, "dense"))
        for key, chunk, layout in engines:
            eng = TS.ContinuousBatchingServer(cfg, comp, max_len=48, slots=2,
                                              prefill_chunk=chunk,
                                              cache_layout=layout, device=d)
            res = eng.run([TS.Request(rid=i, prompt=prompts[i, :n], steps=8)
                           for i, n in enumerate(lens)])
            runs[key] = [res[i]["tokens"].tolist() for i in range(3)]
        fixed = TS.Server(cfg, comp, max_len=48, batch=4, device=d)
        runs["server"] = fixed.generate(prompts, steps=8).cpu().tolist()
        toks[name] = runs
        # teacher-forced logits over the engine's cache layout: prefill 16,
        # then 8 decode steps at per-slot positions
        p = fixed.params
        cache = M.init_cache(cfg, 3, 48, params=p, device=d)
        seq = torch.from_numpy(prompts).to(d)
        with torch.inference_mode():
            rows = [M.prefill(p, cfg, {"tokens": seq[:, :16]}, cache)[0]]
            for i in range(16, 24):
                pos = torch.tensor([i, i - 5, i - 11], dtype=torch.int32,
                                   device=d)
                rows.append(M.decode_step(p, cfg, cache, seq[:, i:i + 1],
                                          pos)[0])
        logits[name] = torch.stack(rows).cpu()
    err = rel_fro(logits["card"], logits["cpu"])
    tag = (f"smoke moe serve {cfg.name} ({cfg.moe.dispatch})"
           if cfg.moe is not None
           else "smoke serve" if cfg.name == "llama-7b-smoke"
           else f"smoke serve {cfg.name}")
    log(f"{tag}: tokens card {json.dumps(toks['card'])} cpu "
        f"{json.dumps(toks['cpu'])}; teacher-forced logits rel err (card vs "
        f"cpu) {err:.3e}")
    require(toks["card"] == toks["cpu"], f"{tag}: tokens differ between the "
            "card and the CPU")
    # fp32 on both; kernels sum in another order: 1e-4 relative Frobenius
    require(err <= 1e-4, f"{tag}: logits differ by {err:.3e}")
    return {"tokens": toks["card"], "logits_rel_err": err}


def _dropfree(cfg):
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="dropfree"))


def _composed_maps(torch, block):
    """{path: (..., n, m) composed map v @ u} of every factorized linear of
    a block, expert banks (one map per expert) and shared experts
    included."""
    out = {}
    for part in ("attn", "ffn"):
        for name, lin in block[part].items():
            subs = (lin.items() if name in ("experts", "shared")
                    else [(None, lin)])
            for sub, sl in subs:
                if "u" in sl:
                    key = f"{part}.{name}" + ("" if sub is None else f".{sub}")
                    out[key] = torch.einsum("...nk,...km->...nm",
                                            sl["v"].cpu(), sl["u"].cpu())
    return out


def _routed_ids(torch, L, store, params, cfg):
    """The MoE layer's routed expert ids from a tapped forward: the
    drop-free dispatch sows them; under the capacity dispatch they are the
    router's top-k over the layer's input (the shared experts' tap), the
    arithmetic of ``moe_apply``."""
    if "ffn/experts_ids" in store:
        return store["ffn/experts_ids"].cpu()
    router = params["stages"][1][0]["ffn"]["router"]
    logits = L.linear(router, store["ffn/shared/in"].float(),
                      dtype=torch.float32)
    return torch.topk(torch.softmax(logits, dim=-1), cfg.moe.top_k,
                      dim=-1)[1].T.reshape(-1).cpu()


def phase_smoke_moe(torch, np, dev="cuda", dispatch="dropfree"):
    """deepseek-v2-lite smoke (fp32, 2 layers) compressed with ``dispatch``
    ("dropfree", or "capacity": the config's own) on the card and on the
    CPU from the same params and tokens: routed ids and, under capacity,
    the routing's drop stat and the report's drop rates exactly equal; then
    a second time on the card, which must give the same bits (every tap's
    covariance is split over T: cov_accum sums in a fixed order)."""
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import cov_accum as cov
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.tree import flatten, tree_map

    cfg = configs.get_smoke_config("deepseek-v2-lite-16b").replace(
        dtype="float32")
    if dispatch == "dropfree":
        cfg = _dropfree(cfg)
    require(cfg.moe.dispatch == dispatch, f"smoke moe: dispatch "
            f"{cfg.moe.dispatch!r}, not {dispatch!r}")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    # 16 x 64 uniform tokens: ~256 routed rows an expert (top-2 of 8) at
    # n = 64, so every expert's covariances have full rank
    calib = {"tokens": rng.integers(0, cfg.vocab_size, (16, 64))}
    t = rng.integers(0, cfg.vocab_size, (8, 65))
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])}
    recipe = P.CompressConfig(ratio=0.6, rank_multiple=1, microbatch=2,
                              calib_mode="fused", refine_epochs=1,
                              moe_dispatch=("dropfree" if dispatch
                                            == "dropfree" else "inherit"))
    out = {}
    dropped = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        # the original stream's routing: the uncompressed model's forward
        # over the calibration tokens, tapped
        store = {}
        pd = tree_map(lambda x, d=d: x.to(d), params)
        with torch.no_grad(), L.sowing(store):
            M.forward_hidden(pd, cfg, {"tokens": torch.from_numpy(
                calib["tokens"]).to(d)})
            ids = _routed_ids(torch, L, store, pd, cfg)
        if "ffn/experts_dropped" in store:
            dropped[name] = store["ffn/experts_dropped"].tolist()
        comp, rep = P.compress_model(params, cfg, calib, recipe, device=d)
        with torch.no_grad():
            loss = float(M.loss_fn(comp, cfg, {k: v.to(d) for k, v
                                               in batch.items()})[1]["ce"])
        out[name] = (comp, rep, loss, ids)
    again, _ = P.compress_model(params, cfg, calib, recipe, device=dev)
    first, tdef = flatten(out["card"][0])
    second, tdef2 = flatten(again)
    repeat_equal = tdef == tdef2 and all(
        torch.equal(a, b) for a, b in zip(first, second))
    # the dense taps' covariances: (2 x 64 tokens, n 64) in fp32
    tap_splits = cov.plan(recipe.microbatch * calib["tokens"].shape[1],
                          cfg.d_model, torch.float32).splits
    flips = int((out["card"][3] != out["cpu"][3]).sum())
    worst, worst_at = 0.0, None
    for si in range(len(out["cpu"][0]["stages"])):
        maps = [_composed_maps(torch, out[run][0]["stages"][si][0])
                for run in ("card", "cpu")]
        for path, want in maps[1].items():
            got = maps[0][path].reshape(-1, *want.shape[-2:])
            want = want.reshape(-1, *want.shape[-2:])
            for i in range(want.shape[0]):
                err = rel_fro(got[i], want[i])
                if err > worst:
                    worst, worst_at = err, f"stage {si} {path} [{i}]"
    lc, lp = out["card"][2], out["cpu"][2]
    rates = {name: out[name][1]["calibration"]["moe_drop_rate"]
             for name in ("card", "cpu")}
    tag = f"smoke moe ({dispatch})"
    log(f"{tag}: routed ids {tuple(out['cpu'][3].shape)} flips (card vs "
        f"cpu) {flips}; composed-map rel err {worst:.3e} at {worst_at}; CE "
        f"card {lc:.6f} cpu {lp:.6f}; drop rates card {rates['card']} cpu "
        f"{rates['cpu']}; [dropped, total] of the whole calibration set "
        f"{dropped}")
    require(flips == 0, f"{tag}: {flips} routed expert ids differ "
            "between the card and the CPU")
    require(rates["card"] == rates["cpu"], f"{tag}: drop rates differ: "
            f"{rates}")
    require(len(set(map(tuple, dropped.values()))) <= 1,
            f"{tag}: dropped choices differ: {dropped}")
    if dispatch == "dropfree":
        require(all(v == 0.0 for v in rates["card"].values()),
                f"{tag}: drop-free dropped {rates['card']}")
    # fp32 on both, well-conditioned per-expert covariances: 1e-3 as llama
    require(worst <= 1e-3, f"{tag} composed maps differ by {worst:.3e} "
            f"({worst_at})")
    require(abs(lc / lp - 1) <= 1e-3, f"{tag} loss {lc} vs {lp}")
    log(f"{tag}: a second compression on the card, factors bitwise "
        f"equal {repeat_equal} ({len(first)} leaves; d_model taps split "
        f"{tap_splits} ways)")
    require(repeat_equal, f"{tag}: two compressions on the card differ")
    served = phase_smoke_serve(torch, np, cfg, out["cpu"][0], dev)
    return {"dispatch": dispatch, "serve": served, "routed_ids": int(out["cpu"][3].numel()),
            "id_flips": flips, "drop_rates": rates["card"],
            "dropped_total": dropped.get("card"),
            "repeat_bitwise_equal": repeat_equal, "tap_splits": tap_splits,
            "map_rel_err": worst, "map_worst_at": worst_at, "ce_cuda": lc,
            "ce_cpu": lp}


def phase_smoke_moe_capacity(torch, np, dev="cuda"):
    """``phase_smoke_moe`` under the config's own capacity dispatch (factor
    1.25): the expert banks' covariances go through cov_accum_banked."""
    return phase_smoke_moe(torch, np, dev, dispatch="capacity")


def _shifted_error(torch, got, want, xpxp):
    """Relative gap of two (n, m) maps as they act on the shifted stream
    whose X′ᵀX′ is ``xpxp``: ||X′(got − want)||_F / ||X′ want||_F, from
    the eigendecomposition of X′ᵀX′ (its null eigenvalues come out of the
    fp32 sums at ±1e-7·λmax: clipped to 0)."""
    lam, q = torch.linalg.eigh(xpxp.double())
    half = q * lam.clamp(min=0.0).sqrt()
    dw = got.double() - want.double()
    return float((half.T @ dw).norm() / (half.T @ want.double()).norm())


def phase_smoke_kimi(torch, np, dev="cuda", dispatch="capacity"):
    """kimi-k2 smoke (fp32, 2 layers: one ``attn_dense_first``, one
    ``attn_moe`` with 8 experts top-2 and one shared expert; 8 query heads
    on 2 KV heads of dim 8) compressed with ``dispatch`` ("capacity": the
    config's own, or "dropfree") on the card and on the CPU from the same
    params and 16 x 32 uniform tokens (ratio 0.6, fused, microbatch 8),
    each with one refine epoch and without: routed ids of the original
    stream, ranks and the report's drop rates exactly equal; the refined
    models' CE within 1e-3, the CPU's served on both with equal tokens
    (``phase_smoke_serve``); the closed-form solves' composed maps within
    1e-3, plainly except the expert banks', compared on the shifted stream
    the solve saw: an expert's X′ᵀX′ holds only its routed rows (under
    capacity only those its C slots kept) and can be ill conditioned or
    singular, and its weak directions are fp32 rounding on either device
    (without refinement, one drop-free expert of condition 9.8e4 moved
    1.1e-3 plainly, 1.8e-4 on its shifted stream, between 1 and 8 CPU
    threads; ``tests/test_torch_kimi.py``).  The refined maps'
    gap is printed, not held: one Adam step moves an expert's coordinates
    by about lr whatever the sign of a gradient that rounding decides, and
    the CPU alone, at 1 thread against 8, puts the capacity banks 3.4e-3
    apart on the shifted stream (2.5e-4 without refinement)."""
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = configs.get_smoke_config("kimi-k2-1t-a32b").replace(
        dtype="float32")
    if dispatch == "dropfree":
        cfg = _dropfree(cfg)
    require(cfg.moe.dispatch == dispatch, f"smoke kimi: dispatch "
            f"{cfg.moe.dispatch!r}, not {dispatch!r}")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    calib = {"tokens": rng.integers(0, cfg.vocab_size, (16, 32))}
    t = rng.integers(0, cfg.vocab_size, (8, 65))
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])}

    def recipe(refine):
        return P.CompressConfig(ratio=0.6, rank_multiple=1, microbatch=8,
                                calib_mode="fused", refine_epochs=1,
                                refine=refine, debug_covs=True,
                                moe_dispatch=("dropfree" if dispatch
                                              == "dropfree" else "inherit"))

    out, dropped, ids = {}, {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        store = {}
        pd = tree_map(lambda x, d=d: x.to(d), params)
        with torch.no_grad(), L.sowing(store):
            M.forward_hidden(pd, cfg, {"tokens": torch.from_numpy(
                calib["tokens"]).to(d)})
            ids[name] = _routed_ids(torch, L, store, pd, cfg)
        if "ffn/experts_dropped" in store:
            dropped[name] = store["ffn/experts_dropped"].tolist()
        for refine in (True, False):
            comp, rep = P.compress_model(params, cfg, calib, recipe(refine),
                                         device=d)
            with torch.no_grad():
                loss = float(M.loss_fn(comp, cfg, {
                    k: v.to(d) for k, v in batch.items()})[1]["ce"])
            out[name, refine] = (comp, rep, loss)
    flips = int((ids["card"] != ids["cpu"]).sum())
    ranks = {key: [[lin["rank"] for lin in u["linears"]]
                   for u in out[key][1]["units"]] for key in out}

    def map_gap(refine):
        worst, worst_at = 0.0, None
        for si, unit in enumerate(out["cpu", refine][1]["units"]):
            specs = {sp.path: sp for sp in P.linear_specs(unit["kind"], cfg)}
            maps = [_composed_maps(torch, out[run, refine][0]["stages"][si][0])
                    for run in ("card", "cpu")]
            for path, want in maps[1].items():
                got = maps[0][path].reshape(-1, *want.shape[-2:])
                want = want.reshape(-1, *want.shape[-2:])
                xpxp = unit["covs"][specs[path].tap]["xpxp"].cpu()
                for i in range(want.shape[0]):
                    err = (_shifted_error(torch, got[i], want[i], xpxp[i])
                           if specs[path].bank else rel_fro(got[i], want[i]))
                    if err > worst:
                        worst, worst_at = err, f"stage {si} {path} [{i}]"
        return worst, worst_at

    solved, solved_at = map_gap(False)
    refined, refined_at = map_gap(True)
    lc, lp = out["card", True][2], out["cpu", True][2]
    rates = {key: out[key][1]["calibration"]["moe_drop_rate"] for key in out}
    tag = f"smoke kimi ({dispatch})"
    log(f"{tag}: routed ids {tuple(ids['cpu'].shape)} flips (card vs cpu) "
        f"{flips}; ranks {ranks['card', True]}; composed-map rel err of the "
        f"solves {solved:.3e} at {solved_at}, of the refined models "
        f"{refined:.3e} at {refined_at} (not held); CE card {lc:.6f} cpu "
        f"{lp:.6f}; drop rates {rates['card', True]}; [dropped, total] of "
        f"the whole calibration set {dropped}")
    require(flips == 0, f"{tag}: {flips} routed expert ids differ "
            "between the card and the CPU")
    require(len({json.dumps(r) for r in ranks.values()}) == 1,
            f"{tag}: ranks differ {ranks}")
    require(len({json.dumps(r, sort_keys=True) for r in rates.values()})
            == 1, f"{tag}: drop rates differ: {rates}")
    require(len(set(map(tuple, dropped.values()))) <= 1,
            f"{tag}: dropped choices differ: {dropped}")
    require(solved <= 1e-3, f"{tag} composed maps of the solves differ by "
            f"{solved:.3e} ({solved_at})")
    require(abs(lc / lp - 1) <= 1e-3, f"{tag} loss {lc} vs {lp}")
    served = phase_smoke_serve(torch, np, cfg, out["cpu", True][0], dev)
    return {"dispatch": dispatch, "serve": served,
            "ranks": ranks["card", True], "routed_ids": int(ids["cpu"].numel()),
            "id_flips": flips, "drop_rates": rates["card", True],
            "dropped_total": dropped.get("card"), "map_rel_err": solved,
            "map_worst_at": solved_at, "refined_map_rel_err": refined,
            "refined_map_worst_at": refined_at, "ce_cuda": lc, "ce_cpu": lp}


# ---------------------------------------------------------------------------
# phase 5: the main path at llama-7b's published widths


def solve_pieces(torch, cfg):
    """Device ms of the solve's torch.linalg calls at the main path's
    shapes (one call each after one warm-up): the eighs of the d_model and
    d_ff covariances and the SVDs of the attention and MLP whitened maps."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    d, f = cfg.d_model, cfg.d_ff
    out = {}
    for name, fn, shape in (
            ("eigh_d", lambda a: torch.linalg.eigh(a.T @ a), (d, d)),
            ("eigh_ff", lambda a: torch.linalg.eigh(a.T @ a), (f, f)),
            ("svd_d_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (d, d)),
            ("svd_ff_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (f, d)),
            ("svd_d_x_ff", lambda a: torch.linalg.svd(
                a, full_matrices=False), (d, f))):
        a = torch.randn(*shape, generator=gen, device="cuda")
        out[name] = time_ms(lambda: fn(a), warmup=1, reps=1)
    return out


def phase_main(torch, ops, dev="cuda", sizes=SIZES, cfg=None):
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import model as M

    layers = sizes["layers"]
    if cfg is None:
        cfg = configs.get_config("llama-7b")
    cfg = cfg.replace(num_layers=layers)
    log(f"main: llama-7b widths d_model {cfg.d_model} heads {cfg.num_heads}"
        f"/{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size}, dtype {cfg.dtype} params {cfg.param_dtype}; "
        f"num_layers cut 32 -> {layers} for the time limit")
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="fused",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"])

    def eval_loss(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[0]) for b in evals]

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = eval_loss(params)
    compressed = eval_loss(comp)
    stages["eval"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rows = lowrank_rows(ops)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    log("main: stage seconds", json.dumps(stages))
    log(f"main: compress wall {t_compress:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log("main: compress_ratio_report",
        json.dumps(repro_torch.compress_ratio_report(params, comp)))
    log("main: launches", json.dumps(launches), "flash_attention by body",
        json.dumps(bodies))
    for u in report["units"]:
        log(f"main: {u['name']} pre/post-refine mse {u['pre_refine_mse']:.6e}"
            f" / {u['post_refine_mse']:.6e}, calib_wall "
            f"{u['calib_wall']:.3f} s, refine_wall {u['refine_wall']:.3f} s,"
            f" ranks {[lin['rank'] for lin in u['linears']]}")
    log(f"main: eval loss dense {dense} compressed {compressed}")
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u["pre_refine_mse"],
                                           u["post_refine_mse"])]
    require(all(math.isfinite(v) for v in vals), f"non-finite: {vals}")
    for name in ("cov_accum", "lowrank_matmul", "flash_attention",
                 "flash_attention_bwd"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the compression path")
    if on_card:
        log("main: solve pieces, one call each at the main path's shapes "
            "(ms)", json.dumps(solve_pieces(torch, cfg)))
    lin = comp["stages"][0][0]["attn"]["wq"]
    want_shape = (layers, cfg.d_model, report["units"][0]["linears"][0]
                  ["rank"])
    require(tuple(lin["v"].shape) == want_shape,
            f"factor shape {tuple(lin['v'].shape)} != {want_shape}")
    return {"stages": stages, "launches": launches,
            "lowrank_rows": rows, "flash_bodies": bodies, "peak_bytes": peak,
            "dense": dense, "compressed": compressed}, cfg, params, comp


# ---------------------------------------------------------------------------
# phase 6: serving at llama-7b widths


def _cache_bytes(M, cfg, slots, max_len, params):
    cache = M.init_cache(cfg, slots, max_len, params=params, device="meta")
    leaves = []
    for per_kind in cache:
        for c in per_kind:
            leaves += list(c.values())
    return sum(t.numel() * t.element_size() for t in leaves)


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, np, ops, cfg, params, comp, dev="cuda", sizes=SIZES):
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    rng = np.random.default_rng(7)
    out = {}

    # (a) fixed batch, dense cache: flash_attention for prefill and decode
    b, plen, steps, max_len = sizes["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    srv = TS.Server(cfg, params, max_len=max_len, batch=b, device=dev)
    _sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    first = srv.generate(prompts, steps=1).cpu()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, steps=steps).cpu()
    t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    require(launches["flash_attention"] > 0,
            "flash_attention never launched by Server.generate")
    require(tuple(toks.shape) == (b, steps) and torch.equal(toks[:, :1],
                                                            first)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"Server tokens malformed: {tuple(toks.shape)}")
    decode_s = t_all - t_prefill
    out["server"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": dict(ops.FLASH_BODIES), "prefill_s": t_prefill,
        "prefill_tokens_per_s": b * plen / t_prefill,
        "decode_tokens_per_s": b * (steps - 1) / decode_s,
        "decode_step_ms": decode_s / (steps - 1) * 1e3,
        "generate_s": t_all, "tokens_head": toks[:, :8].tolist()}
    log("serve (a) Server dense:", json.dumps(out["server"]))

    # (b) continuous batching over the latent cache
    slots, max_len, chunk, n_req, (lo, hi), steps = sizes["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=steps) for i, n in enumerate(lens)]
    eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                      slots=slots, prefill_chunk=chunk,
                                      device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for name in ("flash_attention", "flash_decode", "lowrank_matmul"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the serving path")
    decode_bodies = dict(ops.DECODE_BODIES)
    require(not on_card or decode_bodies.get("wgmma", 0) > 0,
            f"flash_decode's wgmma body never taken: {decode_bodies}")
    require(sorted(res) == list(range(n_req)) and all(
        len(r["tokens"]) == steps and ((r["tokens"] >= 0)
                                       & (r["tokens"] < cfg.vocab_size)).all()
        for r in res.values()), "engine results malformed")
    require(set(eng.prefill_routes.values()) == {"chunked"},
            f"prefill routes {eng.prefill_routes}")
    ttft = [res[i]["first_token"] - res[i]["arrival"] for i in range(n_req)]
    prefill_s = [res[i]["first_token"] - res[i]["admitted"]
                 for i in range(n_req)]
    times = eng.decode_step_times
    latent = _cache_bytes(M, cfg, slots, max_len, eng.params)
    dense = _cache_bytes(M, cfg, slots, max_len, None)
    out["engine"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": dict(ops.FLASH_BODIES),
        "decode_bodies": decode_bodies, "wall_s": wall, "requests": n_req,
        "prompt_lens": lens.tolist(),
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
        "ttft_s_first_slots_median": statistics.median(ttft[:slots]),
        "prefill_tokens_per_s": float(sum(lens)) / sum(prefill_s),
        "decode_steps": len(times),
        "decode_step_ms_median": statistics.median(times) * 1e3,
        "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
        "cache_bytes_latent": latent, "cache_bytes_dense": dense,
        "peak_bytes": peak}
    log("serve (b) engine latent:", json.dumps(out["engine"]))

    # (b') the same requests with the dense layout forced: flash_attention
    # decode over bf16 k/v against flash_decode over the latents
    eng_dense = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                            slots=slots, prefill_chunk=chunk,
                                            cache_layout="dense", device=dev)
    _sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    res_d = eng_dense.run(reqs)
    wall = time.perf_counter() - t0
    times = eng_dense.decode_step_times
    same = sum(int((res_d[i]["tokens"] == res[i]["tokens"]).sum())
               for i in range(n_req))
    out["engine_dense"] = {
        "launches": dict(ops.LAUNCHES), "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": dict(ops.FLASH_BODIES), "wall_s": wall,
        "decode_step_ms_median": statistics.median(times) * 1e3,
        "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
        "tokens_equal_to_latent": same / (n_req * steps)}
    log("serve (b') engine dense:", json.dumps(out["engine_dense"]))

    # (c) one teacher-forced sequence: latent-cache decode against
    # dense-cache decode, and chunked against whole prefill
    plen, n_dec, max_len = sizes["serve_check"]
    p = eng.params
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen + n_dec),
                                        dtype=np.int32)).to(dev)
    logits = {}
    with torch.inference_mode():
        for layout in ("latent", "dense"):
            cache = M.init_cache(cfg, 1, max_len, params=p if layout ==
                                 "latent" else None, device=dev)
            rows = [M.prefill(p, cfg, {"tokens": seq[:, :plen]}, cache)[0]]
            for i in range(plen, plen + n_dec):
                pos = torch.tensor([i], dtype=torch.int32, device=dev)
                rows.append(M.decode_step(p, cfg, cache, seq[:, i:i + 1],
                                          pos)[0])
            logits[layout] = torch.cat(rows)
        # chunked against whole prefill of plen tokens (a last chunk of
        # `chunk` rows) and of plen + 8 (a last chunk of 8 rows, decode's
        # row count): the last row's logits
        def new_cache(layout):
            return M.init_cache(cfg, 1, max_len, params=p if layout ==
                                "latent" else None, device=dev)

        err_chunk = {}
        for layout in ("latent", "dense"):
            for tail in (0, 8):
                cache, end = new_cache(layout), plen + tail
                for c0 in range(0, end, chunk):
                    last, cache = M.prefill(
                        p, cfg, {"tokens": seq[:, c0:min(end, c0 + chunk)]},
                        cache, pos=c0, chunked=True)
                whole = (logits[layout][:1] if tail == 0 else M.prefill(
                    p, cfg, {"tokens": seq[:, :end]}, new_cache(layout))[0])
                key = layout if tail == 0 else f"{layout}_last_chunk_{tail}"
                err_chunk[key] = rel_fro(last, whole)
        # the same two routes with fp32 activations: both caches then hold
        # unrounded keys and values, so they must agree to fp32 rounding
        cfg32 = cfg.replace(dtype="float32")
        for layout in ("latent32", "dense32"):
            cache = M.init_cache(cfg32, 1, max_len, params=p if layout ==
                                 "latent32" else None, device=dev)
            rows = [M.prefill(p, cfg32, {"tokens": seq[:, :plen]}, cache)[0]]
            for i in range(plen, plen + n_dec):
                pos = torch.tensor([i], dtype=torch.int32, device=dev)
                rows.append(M.decode_step(p, cfg32, cache, seq[:, i:i + 1],
                                          pos)[0])
            logits[layout] = torch.cat(rows)
    err_decode = rel_fro(logits["latent"][1:], logits["dense"][1:])
    err_decode32 = rel_fro(logits["latent32"][1:], logits["dense32"][1:])
    err_bf16 = {k: rel_fro(logits[k][1:], logits["dense32"][1:])
                for k in ("latent", "dense")}
    err_prefill = rel_fro(logits["latent"][:1], logits["dense"][:1])
    out["checks"] = {"latent_vs_dense_decode": err_decode,
                     "latent_vs_dense_decode_fp32": err_decode32,
                     "bf16_vs_fp32_decode": err_bf16,
                     "latent_vs_dense_prefill": err_prefill,
                     "chunked_vs_whole": err_chunk}
    log("serve (c) checks (rel Frobenius):", json.dumps(out["checks"]))
    # bf16 activations: the latent path keeps keys and values unrounded in
    # fp32 (U fp32 in flash_decode), the dense path stores them in bf16, so
    # the two differ by bf16 rounding carried through 2 layers; each bf16
    # route is 7.2-7.6 % from the fp32 one on these random weights (this
    # script on an H100, "bf16_vs_fp32_decode" above): 1e-1.  Chunked
    # prefill runs each row through the same kernels in the same tile
    # order (prefill takes lowrank_matmul's large-T body at any row count:
    # ops.batch_invariant); only the cuBLAS latent projection sees another
    # row count: 1e-2
    require(err_decode <= 1e-1, f"latent vs dense decode {err_decode:.3e}")
    # fp32 activations: the same function through two kernels, sums in
    # another order: 1e-4
    require(err_decode32 <= 1e-4,
            f"latent vs dense decode in fp32 {err_decode32:.3e}")
    require(err_prefill <= 1e-1,
            f"latent vs dense prefill {err_prefill:.3e}")
    for k, v in err_chunk.items():
        require(v <= 1e-2, f"chunked vs whole prefill ({k}) {v:.3e}")
    if on_card:
        out["profile"] = {layout: profile_engine(torch, np, TS, cfg, comp,
                                                 layout, sizes)
                          for layout in ("auto", "dense")}
        log("serve (d) device time by kernel:", json.dumps(out["profile"]))
    return out


def device_times(prof):
    """{kernel name: device ms} of a ``torch.profiler`` run, device
    activity only (kernels, copies), summed over every launch."""
    from torch.autograd import DeviceType
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            out[evt.key] = (out.get(evt.key, 0.0)
                            + evt.self_device_time_total / 1e3)
    return out


def top_kernels(kernels, n):
    """The ``n`` largest entries, names cut to 80 characters."""
    top = {}
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:n]:
        top[name[:80]] = top.get(name[:80], 0.0) + ms
    return top


def profile_engine(torch, np, TS, cfg, comp, layout, sizes, *, extras=None,
                   max_len=None):
    """Device time by kernel of a short engine run (8 slots, 256-token
    prompts, 16 steps) under ``torch.profiler`` (device activity only), and
    the device's busy share of the same run's wall time without the
    profiler.  ``extras(i)``: request i's frontend inputs (the multimodal
    archs); ``max_len`` overrides the engine's."""
    from torch.profiler import ProfilerActivity, profile

    slots, max_len_, chunk = sizes["serve_engine"][:3]
    max_len = max_len or max_len_
    rng = np.random.default_rng(11)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (256,),
                                                  dtype=np.int32), steps=16,
                       extras=None if extras is None else extras(i))
            for i in range(slots)]
    eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                      slots=slots, prefill_chunk=chunk,
                                      cache_layout=layout, device="cuda")
    eng.run(reqs)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = statistics.median(eng.decode_step_times) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    wall_profiled = time.perf_counter() - t0
    kernels = device_times(prof)
    busy = sum(kernels.values())
    top = top_kernels(kernels, 10)
    # flash_attention's kernels: the tile bodies, the split body and its
    # merge; flash_decode's: fdec_split_u, the keys bodies, values and out
    fa_ms = sum(ms for name, ms in kernels.items() if any(
        f"flash_{body}" in name for body in ("tile", "wgmma", "split",
                                             "merge")))
    fd_ms = sum(ms for name, ms in kernels.items() if "fdec_" in name)
    # lowrank_matmul's and grouped_matmul's kernels, and the dtype casts
    # (the factors and expert banks cast to the activations' dtype a call)
    families = {"lowrank_matmul_ms": ("gemm_wgmma", "skinny_mma",
                                      "skinny_fma", "splitk_reduce",
                                      "gemm_f32"),
                "grouped_matmul_ms": ("grouped_",),
                "cast_copy_ms": ("copy_kern",)}
    by_family = {key: sum(ms for name, ms in kernels.items()
                          if any(f in name for f in marks))
                 for key, marks in families.items()}
    return {"wall_ms": wall * 1e3, "wall_ms_profiled": wall_profiled * 1e3,
            "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
            "flash_attention_ms": fa_ms,
            "flash_attention_share": fa_ms / max(busy, 1e-9),
            "flash_decode_ms": fd_ms,
            "flash_decode_share": fd_ms / max(busy, 1e-9), **by_family,
            "decode_step_ms_median": step_ms, "top_kernels_ms": top}


# ---------------------------------------------------------------------------
# phase 7: drop-free MoE compression at deepseek-v2-lite's published widths


def moe_solve_pieces(torch, cfg):
    """Device ms of one call each (after one warm-up) of the solve's
    torch.linalg work per expert and for the dense-first FFN: the eighs of
    the d_model, expert d_ff and dense d_ff covariances, the SVDs of an
    expert's whitened (d_ff, d_model) / (d_model, d_ff) maps and of the
    dense FFN's (dense d_ff, d_model) map."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    d, f, fd = cfg.d_model, cfg.moe.d_ff, cfg.moe.dense_d_ff
    out = {}
    for name, fn, shape in (
            ("eigh_d", lambda a: torch.linalg.eigh(a.T @ a), (d, d)),
            ("eigh_expert_ff", lambda a: torch.linalg.eigh(a.T @ a), (f, f)),
            ("eigh_dense_ff", lambda a: torch.linalg.eigh(a.T @ a), (fd, fd)),
            ("svd_expert_ff_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (f, d)),
            ("svd_expert_d_x_ff", lambda a: torch.linalg.svd(
                a, full_matrices=False), (d, f)),
            ("svd_dense_ff_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (fd, d))):
        a = torch.randn(*shape, generator=gen, device="cuda")
        out[name] = time_ms(lambda: fn(a), warmup=1, reps=1)
    return out


def moe_forward_syncs(torch, cfg, comp, batch):
    """Run the compressed MoE layer's forward (router, the config's
    dispatch: drop-free with three factorized ``grouped_matmul`` banks, or
    capacity with three batched factorized banks; shared experts) on the
    phase's microbatch under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any operation that synchronizes the host with the card:
    nothing of the routing may be read on the host."""
    from repro_torch.models import layers as L
    from repro_torch.models import mlp as MLP

    p = comp["stages"][1][0]["ffn"]
    x = L.embed(comp["embed"], batch["tokens"], torch.bfloat16)
    with torch.no_grad():
        MLP.moe_apply(p, x, cfg)              # warm-up, outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = MLP.moe_apply(p, x, cfg)
            err = None
        except RuntimeError as exc:
            err = str(exc)[:300]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    require(err is None, f"the MoE forward synchronized the host: {err}")
    require(bool(torch.isfinite(y).all()) and math.isfinite(float(aux)),
            "the MoE forward under the sync check is not finite")
    return {"mode": "error", "raised": err, "shape": list(x.shape)}


def busy_share(torch, fn, top=10):
    """Wall ms of ``fn()`` (after one warm-up) and the device's busy share
    of it: the device time of its kernels under ``torch.profiler`` (device
    activity only) over the wall time of a run without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_times(prof)
    busy = sum(kernels.values())
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall, "top_kernels_ms": top_kernels(
                kernels, top)}


def eval_busy_share(torch, M, cfg, params, batch):
    """The device's busy share of one eval forward."""
    def run():
        with torch.no_grad():
            M.loss_fn(params, cfg, batch)

    return busy_share(torch, run, top=8)


def phase_moe(torch, ops, dev="cuda", sizes=SIZES, cfg=None,
              dispatch="dropfree", calib_seed=1, refine_epochs=1):
    """Phase 7 (``dispatch="dropfree"``, forced by the recipe) or phase 8
    (``"capacity"``: the config's own dispatch, ``moe_dispatch="inherit"``):
    deepseek-v2-lite at published widths compressed on the card, then the
    dense and compressed eval losses.  Returns (summary, cfg, compressed
    params): phase 9 serves them.  ``calib_seed`` seeds the calibration and
    eval tokens, ``refine_epochs`` is the recipe's
    (``tests/serve_check_sweep.py`` varies both)."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import model as M

    layers = sizes["moe_layers"]
    if cfg is None:
        cfg = configs.get_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(num_layers=layers)
    if dispatch == "dropfree":
        cfg = _dropfree(cfg)
    require(cfg.moe.dispatch == dispatch,
            f"moe: dispatch {cfg.moe.dispatch!r}, not {dispatch!r}")
    tag = "moe" if dispatch == "dropfree" else "moe capacity"
    m = cfg.mla
    log(f"{tag}: deepseek-v2-lite widths d_model {cfg.d_model} heads "
        f"{cfg.num_heads}, MLA kv_lora {m.kv_lora_rank} nope "
        f"{m.qk_nope_head_dim} rope {m.qk_rope_head_dim} v {m.v_head_dim}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_ff "
        f"{cfg.moe.d_ff} + {cfg.moe.num_shared_experts} shared, dense d_ff "
        f"{cfg.moe.dense_d_ff}, vocab {cfg.vocab_size}, dtype {cfg.dtype} "
        f"params {cfg.param_dtype}, dispatch {cfg.moe.dispatch} (capacity "
        f"factor {cfg.moe.capacity_factor}); num_layers cut 27 -> {layers} "
        "for the time limit")
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(calib_seed)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(
        ratio=0.6, calib_mode="fused", refine_epochs=refine_epochs,
        microbatch=sizes["microbatch"],
        moe_dispatch="dropfree" if dispatch == "dropfree" else "inherit")

    def eval_loss(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[1]["ce"]) for b in evals]

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = eval_loss(params)
    compressed = eval_loss(comp)
    stages["eval"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rows = lowrank_rows(ops)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    ratio = repro_torch.compress_ratio_report(params, comp)
    log(f"{tag}: stage seconds", json.dumps(stages))
    log(f"{tag}: compress wall {t_compress:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"{tag}: compress_ratio_report", json.dumps(ratio))
    log(f"{tag}: launches", json.dumps(launches))
    log(f"{tag}: calibration", json.dumps(
        {k: report["calibration"][k] for k in
         ("mode", "tapped_forwards", "moe_dispatch", "moe_drop_rate")}))
    ranks = {}
    for u in report["units"]:
        log(f"{tag}: {u['name']} pre/post-refine mse "
            f"{u['pre_refine_mse']:.6e} / {u['post_refine_mse']:.6e}, "
            f"calib_wall {u['calib_wall']:.3f} s, refine_wall "
            f"{u['refine_wall']:.3f} s")
        ranks.update({lin["path"]: lin["rank"] for lin in u["linears"]})
    log(f"{tag}: ranks", json.dumps(ranks))
    log(f"{tag}: eval CE dense {dense} compressed {compressed}")
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u["pre_refine_mse"],
                                           u["post_refine_mse"])]
    require(all(math.isfinite(v) for v in vals), f"non-finite: {vals}")
    rates = report["calibration"]["moe_drop_rate"]
    require(rates and all(0.0 <= r < 1.0 for r in rates.values()),
            f"{tag}: drop rates {rates} outside [0, 1)")
    # the dispatch's own kernels: grouped_matmul under drop-free; under
    # capacity the banked covariances, and no grouped_matmul at all
    need = (("grouped_matmul",) if dispatch == "dropfree"
            else ("cov_accum_banked",))
    for name in need + ("cov_accum", "lowrank_matmul", "flash_attention",
                        "flash_attention_bwd"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the MoE compression path")
    if dispatch == "capacity":
        require(launches["grouped_matmul"] == 0,
                f"{tag}: grouped_matmul launched "
                f"{launches['grouped_matmul']} times on the capacity path")
    want_ranks = {"attn.wq": 744, "attn.wkv_a": 272, "attn.wk_b": 248,
                  "attn.wv_b": 248, "attn.wo": 616, "ffn.gate": 1040,
                  "ffn.experts.gate": 504, "ffn.experts.down": 504,
                  "ffn.shared.up": 712}
    if cfg.d_model == 2048:     # the published widths (PERF.md's table)
        require(all(ranks.get(k) == v for k, v in want_ranks.items()),
                f"ranks {ranks} differ from {want_ranks}")
    k = ranks["ffn.experts.gate"]
    bank = comp["stages"][1][0]["ffn"]["experts"]["gate"]
    require(tuple(bank["v"].shape) == (cfg.moe.num_experts, cfg.d_model, k)
            and tuple(bank["u"].shape) == (cfg.moe.num_experts, k,
                                           cfg.moe.d_ff),
            f"expert factors {tuple(bank['v'].shape)} / "
            f"{tuple(bank['u'].shape)}")
    extra = {}
    if on_card:
        extra["host_syncs"] = moe_forward_syncs(torch, cfg, comp, evals[0])
        log(f"{tag}: host syncs in the compressed MoE layer's forward "
            "(torch.cuda.set_sync_debug_mode)", json.dumps(extra["host_syncs"]))
        if dispatch == "dropfree":   # phase 8 solves the same shapes
            extra["solve_pieces_ms"] = moe_solve_pieces(torch, cfg)
            log(f"{tag}: solve pieces, one call each at the MoE path's "
                "shapes (ms)", json.dumps(extra["solve_pieces_ms"]))
        extra["eval_profile"] = eval_busy_share(torch, M, cfg, comp,
                                                evals[0])
        log(f"{tag}: compressed eval forward, device time by kernel",
            json.dumps(extra["eval_profile"]))
    return {"dispatch": dispatch, "drop_rates": rates,
            "stages": stages, "launches": launches,
            "lowrank_rows": rows, "flash_bodies": bodies, "peak_bytes": peak,
            "compress_wall_s": t_compress, "ratio": ratio, "ranks": ranks,
            "dense": dense, "compressed": compressed, **extra}, cfg, comp


# ---------------------------------------------------------------------------
# phase 9: serving deepseek-v2-lite at its published widths


def _mla_cache_bytes_per_token(cfg):
    """Bytes a token takes in one MLA layer's cache: {c, kr} as stored, and
    the expanded per-head K / V that MHA would keep instead."""
    m, eb = cfg.mla, 2 if cfg.dtype == "bfloat16" else 4
    return ((m.kv_lora_rank + m.qk_rope_head_dim) * eb,
            cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                             + m.v_head_dim) * eb)


def _drops(torch, L, fn):
    """[dropped, total] routed choices of the capacity MoE layer sown by one
    call of ``fn`` (the last MoE layer's)."""
    store = {}
    with torch.inference_mode(), L.sowing(store):
        fn()
    return [int(v) for v in store["experts_dropped"].tolist()]


def _expert_loads(torch, L, cfg, fn):
    """Routed choices an expert of the MoE layer got in one call of ``fn``
    (run under drop-free, whose ``experts_ids`` tap holds every choice; the
    router does not depend on the dispatch)."""
    store = {}
    with torch.inference_mode(), L.sowing(store):
        fn()
    return torch.bincount(store["experts_ids"].long(),
                          minlength=cfg.moe.num_experts).cpu()


def capacity_routing(torch, L, M, cfg, params, prompts, first, max_len):
    """Where the capacity layer's drops come from, for ``params`` on
    ``prompts``: the whole prefill's and one decode step's [dropped, total]
    under capacity, and each expert's load from the same calls under
    drop-free.  Choices past an expert's C slots are the ones dropped, so
    the drops must equal sum(max(load - C, 0)) exactly (C = max(ceil(T k /
    E factor), k)).  One MoE layer only: behind a second, the two
    dispatches would feed it different inputs."""
    require(cfg.num_layers - cfg.moe.first_k_dense == 1,
            f"capacity routing: {cfg.num_layers - cfg.moe.first_k_dense} MoE "
            "layers, not 1")
    b, plen = prompts.shape
    dev = prompts.device
    free = _dropfree(cfg)
    m = cfg.moe
    out = {}
    for run, tokens in (("prefill", b * plen), ("decode", b)):
        cap = max(int(math.ceil(tokens * m.top_k / m.num_experts
                                * m.capacity_factor)), m.top_k)
        fns = {}
        if run == "prefill":
            caches = [M.init_cache(cfg, b, max_len, device=dev)
                      for _ in range(2)]
            for c, cache in zip((cfg, free), caches):
                fns[c.moe.dispatch] = (lambda c=c, cache=cache: M.prefill(
                    params, c, {"tokens": prompts}, cache))
        else:
            for c, cache in zip((cfg, free), caches):
                fns[c.moe.dispatch] = (lambda c=c, cache=cache: M.decode_step(
                    params, c, cache, first, plen))
        dropped, total = _drops(torch, L, fns["capacity"])
        loads = _expert_loads(torch, L, cfg, fns["dropfree"])
        over = (loads - cap).clamp(min=0)
        top = loads.sort(descending=True).values
        out[run] = {
            "tokens": tokens, "capacity": cap, "dropped": dropped,
            "total": total, "drop_rate": dropped / total,
            "load_over_capacity": int(over.sum()),
            "experts_over_capacity": int((over > 0).sum()),
            "empty_experts": int((loads == 0).sum()),
            "max_load": int(top[0]), "mean_load": total / m.num_experts,
            "top8_share": float(top[:8].sum()) / total,
            "loads": loads.tolist()}
        require(0 <= dropped < total, f"capacity {run}: {dropped} of "
                f"{total} choices dropped")
        require(int(loads.sum()) == total and int(over.sum()) == dropped,
                f"capacity {run}: {dropped} of {total} choices dropped, but "
                f"the drop-free loads ({int(loads.sum())} choices) put "
                f"{int(over.sum())} past C {cap}")
    return out


def decode_syncs(torch, M, cfg, eng):
    """The decode step's host syncs: ``decode_step`` on device tokens and
    per-slot positions under ``torch.cuda.set_sync_debug_mode("error")``
    (any synchronizing operation raises), then one step of the engine
    ``eng`` as ``ContinuousBatchingServer.run`` makes it (host tokens and
    positions uploaded, the next tokens read back) under ``"warn"``, its
    warnings counted."""
    import warnings

    slots, max_len = eng.slots, eng.max_len
    cache = M.init_cache(cfg, slots, max_len, params=eng.params,
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (slots, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    pos = torch.randint(0, max_len - 1, (slots,), generator=gen,
                        device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        M.decode_step(eng.params, cfg, cache, tokens, pos)    # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            M.decode_step(eng.params, cfg, cache, tokens, pos)
            err = None
        except RuntimeError as exc:
            err = str(exc)[:300]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    tok_np = tokens.cpu().numpy()
    pos_np = pos.cpu().numpy()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            nxt, _ = eng._decode(eng.params, cache, eng._tokens(tok_np),
                                 eng._tokens(pos_np))
            nxt.cpu().numpy()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    engine_step = sum("synchroniz" in str(w.message) for w in caught)
    return {"decode_step_raised": err, "decode_step_syncs": 0 if err is None
            else None, "engine_step_syncs": engine_step}


def phase_serve_moe(torch, np, ops, cfg, comp, dev="cuda", sizes=SIZES):
    """Phase 9: phase 7's (drop-free) or phase 8's (capacity) compressed
    deepseek-v2-lite served through MLA's {"c", "kr"} cache at phase 6's
    shapes: (a) ``Server`` (whole prefill: ``flash_attention`` at head dim
    192), (b) ``ContinuousBatchingServer`` (chunked prefill and decode:
    absorbed einsums), each with its launches; under drop-free one
    teacher-forced sequence, decode after prefill and chunked prefill
    against whole prefill (bf16 and fp32 activations); the decode step's
    host syncs; a profiled engine run."""
    from repro_torch.launch import serve as TS
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    dispatch = cfg.moe.dispatch
    tag = f"serve moe ({dispatch})"
    on_card = torch.device(dev).type == "cuda"
    rng = np.random.default_rng(17)
    out = {"dispatch": dispatch}

    def kernel_gates(run, launches):
        require(launches["lowrank_matmul"] > 0,
                f"{tag} {run}: lowrank_matmul never launched")
        require(launches["flash_decode"] == 0, f"{tag} {run}: flash_decode "
                f"launched {launches['flash_decode']} times (MLA keeps "
                "{c, kr})")
        if dispatch == "dropfree":
            require(launches["grouped_matmul"] > 0,
                    f"{tag} {run}: grouped_matmul never launched")
        else:
            require(launches["grouped_matmul"] == 0, f"{tag} {run}: "
                    f"grouped_matmul launched {launches['grouped_matmul']} "
                    "times under capacity")

    # (a) fixed batch: whole prefill (expanded), then absorbed decode
    b, plen, steps, max_len = sizes["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    srv = TS.Server(cfg, comp, max_len=max_len, batch=b, device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    first = srv.generate(prompts, steps=1).cpu()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, steps=steps).cpu()
    t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bodies = dict(ops.FLASH_BODIES)
    # every sub-block is MLA, whose only attention launch is whole prefill
    # with q padded to qk_nope + qk_rope (192 at the published widths): all
    # launches in the wgmma body are flash_wgmma<192>
    kinds = sorted({k for st in B.stage_program(cfg) for k in st.kinds})
    require(all(k.startswith("mla_") for k in kinds),
            f"{tag}: sub-block kinds {kinds} are not all MLA")
    require(launches["flash_attention"] > 0,
            f"{tag}: flash_attention never launched by Server.generate")
    require(not on_card or bodies == {"wgmma": launches["flash_attention"]},
            f"{tag}: flash_attention bodies {bodies} (want the wgmma body "
            "only)")
    kernel_gates("Server", launches)
    require(tuple(toks.shape) == (b, steps) and torch.equal(toks[:, :1],
                                                            first)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{tag}: Server tokens malformed: {tuple(toks.shape)}")
    decode_s = t_all - t_prefill
    out["server"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "grouped_rows": dict(sorted(ops.GROUPED_ROWS.items())),
        "flash_bodies": bodies,
        "prefill_s": t_prefill, "ttft_s": t_prefill,
        "prefill_tokens_per_s": b * plen / t_prefill,
        "decode_tokens_per_s": b * (steps - 1) / decode_s,
        "decode_step_ms": decode_s / (steps - 1) * 1e3,
        "generate_s": t_all, "peak_bytes": peak,
        "tokens_head": toks[:, :8].tolist()}
    if dispatch == "capacity":
        # the capacity layer's drops in the Server's prefill (C 480 at 8 x
        # 512 tokens) and in one decode step of its 8 slots (C 6), with each
        # expert's load, for the compressed model and the dense one it was
        # compressed from (phase 8's seed) on the same prompts
        seq = torch.from_numpy(prompts).to(dev)
        routing = {"compressed": capacity_routing(
            torch, L, M, cfg, srv.params, seq, first.to(dev), max_len)}
        dense = M.init_params(cfg, 0, device=dev)
        routing["dense"] = capacity_routing(torch, L, M, cfg, dense, seq,
                                            first.to(dev), max_len)
        del dense
        out["server"]["routing"] = routing
    log(f"{tag} (a) Server:", json.dumps(out["server"]))

    # (b) continuous batching: chunked prefill and decode, both absorbed
    slots, max_len, chunk, n_req, (lo, hi), steps = sizes["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=steps) for i, n in enumerate(lens)]
    eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                      slots=slots, prefill_chunk=chunk,
                                      device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kernel_gates("engine", launches)
    require(sorted(res) == list(range(n_req)) and all(
        len(r["tokens"]) == steps and ((r["tokens"] >= 0)
                                       & (r["tokens"] < cfg.vocab_size)).all()
        for r in res.values()), f"{tag}: engine results malformed")
    require(set(eng.prefill_routes.values()) == {"chunked"},
            f"{tag}: prefill routes {eng.prefill_routes}")
    ttft = [res[i]["first_token"] - res[i]["arrival"] for i in range(n_req)]
    prefill_s = [res[i]["first_token"] - res[i]["admitted"]
                 for i in range(n_req)]
    times = eng.decode_step_times
    c_bytes, expanded = _mla_cache_bytes_per_token(cfg)
    layers = cfg.num_layers
    cache_bytes = _cache_bytes(M, cfg, slots, max_len, eng.params)
    require(cache_bytes == c_bytes * slots * max_len * layers,
            f"{tag}: cache bytes {cache_bytes}, not {c_bytes} a token a "
            "layer")
    out["engine"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "grouped_rows": dict(sorted(ops.GROUPED_ROWS.items())),
        "flash_bodies": dict(ops.FLASH_BODIES), "wall_s": wall,
        "requests": n_req, "prompt_lens": lens.tolist(),
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
        "ttft_s_first_slots_median": statistics.median(ttft[:slots]),
        "prefill_tokens_per_s": float(sum(lens)) / sum(prefill_s),
        "decode_steps": len(times),
        "decode_step_ms_median": statistics.median(times) * 1e3,
        "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
        "cache_bytes": cache_bytes,
        "cache_bytes_per_token_per_layer": c_bytes,
        "expanded_kv_bytes_per_token_per_layer": expanded,
        "peak_bytes": peak}
    log(f"{tag} (b) engine:", json.dumps(out["engine"]))

    # (c) drop-free only: one teacher-forced sequence.  Decode after a
    # whole prefill against the full forward's rows, and chunked prefill
    # (a last chunk of `chunk` rows, and one of 8) against whole prefill;
    # in bf16 activations and in fp32
    if dispatch == "dropfree":
        plen, n_dec, max_len = sizes["serve_check"]
        seq = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (1, plen + n_dec),
                                            dtype=np.int32)).to(dev)
        p = eng.params
        checks = {}
        with torch.inference_mode():
            for name, c in (("bf16", cfg), ("fp32",
                                            cfg.replace(dtype="float32"))):
                hidden, _ = M.forward_hidden(p, c, {"tokens": seq})
                full = M.logits_from_hidden(p, c, hidden[:, plen - 1:])[0]
                cache = M.init_cache(c, 1, max_len, device=dev)
                rows = [M.prefill(p, c, {"tokens": seq[:, :plen]},
                                  cache)[0]]
                for i in range(plen, plen + n_dec):
                    rows.append(M.decode_step(p, c, cache, seq[:, i:i + 1],
                                              i)[0])
                rows = torch.cat(rows)
                checks[f"prefill_vs_forward_{name}"] = rel_fro(rows[:1],
                                                               full[:1])
                checks[f"decode_vs_forward_{name}"] = rel_fro(rows[1:],
                                                              full[1:])
                for tail in (0, 8):
                    end = plen + tail
                    cache = M.init_cache(c, 1, max_len, device=dev)
                    for c0 in range(0, end, chunk):
                        last, cache = M.prefill(
                            p, c, {"tokens": seq[:, c0:min(end, c0 + chunk)]},
                            cache, pos=c0, chunked=True)
                    whole_cache = M.init_cache(c, 1, max_len, device=dev)
                    whole = M.prefill(p, c, {"tokens": seq[:, :end]},
                                      whole_cache)[0]
                    key = f"chunked_vs_whole_{name}_last_chunk_" \
                        f"{chunk if tail == 0 else tail}"
                    checks[key] = rel_fro(last, whole)
                    checks[key.replace("chunked_vs_whole", "cache_c")] = \
                        rel_fro(cache[-1][0]["c"][..., :end, :],
                                whole_cache[-1][0]["c"][..., :end, :])
        out["checks"] = checks
        log(f"{tag} (c) checks (rel Frobenius):", json.dumps(checks))
        # fp32: absorbed against expanded attention and chunked against
        # whole are the same function summed in another order: 1e-3.
        # bf16: each route rounds its own products to bf16 (expanded: k, v
        # and the attention in bf16; absorbed: fp32 from the bf16 cache);
        # two runs on the H100 read 1.3e-2 to 2.4e-2: 5e-2, twice the
        # largest (phase 3 holds each bf16 body to its plain version at
        # these shapes)
        for key, val in checks.items():
            lim = 1e-3 if "fp32" in key else 5e-2
            require(math.isfinite(val) and val <= lim,
                    f"{tag}: {key} {val:.3e} > {lim:.0e}")

    if on_card:
        out["host_syncs"] = decode_syncs(torch, M, cfg, eng)
        log(f"{tag} (d) host syncs (torch.cuda.set_sync_debug_mode):",
            json.dumps(out["host_syncs"]))
        require(out["host_syncs"]["decode_step_raised"] is None,
                f"{tag}: the decode step synchronized the host: "
                f"{out['host_syncs']['decode_step_raised']}")
        out["profile"] = profile_engine(torch, np, TS, cfg, comp, "auto",
                                        sizes)
        log(f"{tag} (e) device time by kernel:", json.dumps(out["profile"]))
    return out


# ---------------------------------------------------------------------------
# phase 10: gemma3-1b at its published widths (sliding-window family)


def phase_gemma(torch, np, ops, dev="cuda", sizes=SIZES, cfg=None):
    """gemma3-1b at published widths compressed with phase 5's recipe, then
    served at phase 6's shapes: (a) ``Server`` (whole prefill: windowed
    ``flash_attention`` in the local layers, plain causal in the global
    ones, all at head dim 256; decode: ``ring_decode``'s einsums in the
    local layers, the split body over the global layers' dense cache), (b)
    the engine (every request exact-length whole prefill; prompts past 512
    take ``_write_ring``'s L >= W branch), (c) one teacher-forced sequence,
    decode against one forward over the same tokens across the rings'
    wrap, in bf16 and fp32 activations, (d) the decode step's host syncs,
    (e) a profiled engine run.  Counts zeroed before each run and read
    after."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.launch import serve as TS
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    if cfg is None:
        cfg = configs.get_config("gemma3-1b")
    full_layers = cfg.num_layers
    layers = sizes["gemma_layers"]
    cfg = cfg.replace(num_layers=layers)
    tag = "gemma"
    program = [(st.kinds, st.n) for st in B.stage_program(cfg)]
    log(f"{tag}: gemma3-1b widths d_model {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size}, window {cfg.sliding_window}, "
        f"global every {cfg.global_every}, rope theta {cfg.rope_theta} / "
        f"{cfg.rope_theta_global}, dtype {cfg.dtype} params "
        f"{cfg.param_dtype}; {layers} of {full_layers} layers; stages "
        f"{program}")
    kinds = {k for kk, _ in program for k in kk}
    require(kinds <= {"attn_local", "attn_global"},
            f"{tag}: sub-block kinds {sorted(kinds)}")
    # every attention call pads nothing: head dim 256 is compiled, so the
    # wgmma launches below are flash_wgmma<256>
    dpad = ops._padded_head_dim(cfg.head_dim)
    require(dpad == cfg.head_dim, f"{tag}: head dim {cfg.head_dim} pads to "
            f"{dpad}")
    out = {"layers": layers, "program": [[list(k), n] for k, n in program]}

    # compression (phase 5's recipe)
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="fused",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"])

    def eval_loss(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[0]) for b in evals]

    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = eval_loss(params)
    compressed = eval_loss(comp)
    stages["eval"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del params
    out["compress"] = {
        "stages": stages, "wall_s": t_compress, "peak_bytes": peak,
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": bodies, "dense": dense, "compressed": compressed,
        "ranks": [lin["rank"] for lin in report["units"][0]["linears"]],
        "units": [[u["name"], u["pre_refine_mse"], u["post_refine_mse"]]
                  for u in report["units"]]}
    log(f"{tag}: compress", json.dumps(out["compress"]))
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u["pre_refine_mse"],
                                           u["post_refine_mse"])]
    require(all(math.isfinite(v) for v in vals), f"{tag}: non-finite {vals}")
    for name in ("cov_accum", "lowrank_matmul", "flash_attention",
                 "flash_attention_bwd"):
        require(launches[name] > 0,
                f"{tag}: kernel {name} never launched on compression")
    require(not on_card or bodies.get("wgmma", 0) > 0,
            f"{tag}: flash_attention's wgmma body never taken: {bodies}")
    require(len(report["units"]) == layers,
            f"{tag}: {len(report['units'])} units for {layers} layers")

    def kernel_gates(run, launches, bodies):
        require(launches["lowrank_matmul"] > 0,
                f"{tag} {run}: lowrank_matmul never launched")
        require(launches["flash_decode"] == 0, f"{tag} {run}: flash_decode "
                f"launched {launches['flash_decode']} times (qk_norm keeps "
                "the caches dense)")
        require(not on_card or bodies.get("wgmma", 0) > 0,
                f"{tag} {run}: no prefill in the wgmma body: {bodies}")
        # every decode over a global layer's dense cache (4 query heads on
        # 1, bf16) takes the tensor-core GQA body
        require(not on_card or (bodies.get("split_mma", 0) > 0
                                and bodies.get("split", 0) == 0),
                f"{tag} {run}: decode outside the split_mma body: {bodies}")

    # (a) fixed batch
    rng = np.random.default_rng(23)
    b, plen, steps, max_len = sizes["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    srv = TS.Server(cfg, comp, max_len=max_len, batch=b, device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    first = srv.generate(prompts, steps=1).cpu()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, steps=steps).cpu()
    t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kernel_gates("Server", launches, bodies)
    require(tuple(toks.shape) == (b, steps) and torch.equal(toks[:, :1],
                                                            first)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{tag}: Server tokens malformed: {tuple(toks.shape)}")
    decode_s = t_all - t_prefill
    out["server"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": bodies, "prefill_s": t_prefill, "ttft_s": t_prefill,
        "prefill_tokens_per_s": b * plen / t_prefill,
        "decode_tokens_per_s": b * (steps - 1) / decode_s,
        "decode_step_ms": decode_s / (steps - 1) * 1e3,
        "generate_s": t_all, "peak_bytes": peak,
        "tokens_head": toks[:, :8].tolist()}
    log(f"{tag} (a) Server:", json.dumps(out["server"]))

    # (b) continuous batching: exact-length whole prefill, batched decode
    slots, max_len, chunk, n_req, (lo, hi), steps = sizes["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=steps) for i, n in enumerate(lens)]
    eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                      slots=slots, prefill_chunk=chunk,
                                      device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kernel_gates("engine", launches, bodies)
    require(sorted(res) == list(range(n_req)) and all(
        len(r["tokens"]) == steps and ((r["tokens"] >= 0)
                                       & (r["tokens"] < cfg.vocab_size)).all()
        for r in res.values()), f"{tag}: engine results malformed")
    require(set(eng.prefill_routes.values()) == {"whole_exact"},
            f"{tag}: prefill routes {eng.prefill_routes}")
    window = cfg.sliding_window
    require(int(lens.max()) >= window,
            f"{tag}: no prompt reaches the window {window}: {lens.tolist()}")
    ttft = [res[i]["first_token"] - res[i]["arrival"] for i in range(n_req)]
    prefill_s = [res[i]["first_token"] - res[i]["admitted"]
                 for i in range(n_req)]
    times = eng.decode_step_times
    # cache bytes from the shapes: rings of min(window, max_len) slots in
    # the local layers, full-length dense caches in the global ones, against
    # a full-length dense cache in every layer
    eb = 2 if cfg.dtype == "bfloat16" else 4
    ring = _cache_bytes(M, cfg, slots, max_len, eng.params)
    full = layers * slots * max_len * 2 * cfg.num_kv_heads * cfg.head_dim * eb
    out["engine"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": bodies, "wall_s": wall, "requests": n_req,
        "prompt_lens": lens.tolist(),
        "prompts_past_window": int((lens >= window).sum()),
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
        "ttft_s_first_slots_median": statistics.median(ttft[:slots]),
        "prefill_tokens_per_s": float(sum(lens)) / sum(prefill_s),
        "decode_steps": len(times),
        "decode_step_ms_median": statistics.median(times) * 1e3,
        "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
        "cache_bytes": ring, "cache_bytes_dense_full_length": full,
        "cache_share": ring / full, "peak_bytes": peak}
    log(f"{tag} (b) engine:", json.dumps(out["engine"]))

    # (c) one teacher-forced sequence: a prefill, then decode step by step
    # across the rings' wrap, against one forward over the same tokens
    plen, n_dec, max_len = sizes["gemma_check"]
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen + n_dec),
                                        dtype=np.int32)).to(dev)
    p = eng.params
    checks = {"decode_positions": [plen, plen + n_dec - 1]}
    logits = {}
    with torch.inference_mode():
        for name, c in (("bf16", cfg), ("fp32", cfg.replace(dtype="float32"))):
            hidden, _ = M.forward_hidden(p, c, {"tokens": seq})
            full_rows = M.logits_from_hidden(p, c, hidden[:, plen - 1:])[0]
            del hidden
            cache = M.init_cache(c, 1, max_len, device=dev)
            rows = [M.prefill(p, c, {"tokens": seq[:, :plen]}, cache)[0]]
            for i in range(plen, plen + n_dec):
                rows.append(M.decode_step(p, c, cache, seq[:, i:i + 1],
                                          i)[0])
            rows = torch.cat(rows)
            checks[f"prefill_vs_forward_{name}"] = rel_fro(rows[:1],
                                                           full_rows[:1])
            checks[f"decode_vs_forward_{name}"] = rel_fro(rows[1:],
                                                          full_rows[1:])
            logits[name] = (rows[1:], full_rows[1:])
            del rows, full_rows, cache
    # how far each bf16 route lies from the fp32 forward: bf16's own
    # rounding of this model, which bounds the two routes' disagreement
    checks["forward_bf16_vs_fp32"] = rel_fro(logits["bf16"][1],
                                             logits["fp32"][1])
    checks["decode_bf16_vs_fp32"] = rel_fro(logits["bf16"][0],
                                            logits["fp32"][1])
    del logits
    out["checks"] = checks
    log(f"{tag} (c) checks (rel Frobenius):", json.dumps(checks))
    # fp32: decode (ring einsums, the split body) and the forward
    # (flash_attention's tile bodies) are one function summed in other
    # orders: 1e-3.  bf16: each route rounds its own activations, and this
    # model's bf16 forward lies 2.4e-2 from its fp32 forward on one
    # sequence (an H100 probe); the two bf16 routes' errors are independent
    # and alike, so they may disagree by about sqrt(2) times that: at most
    # twice the bf16 forward's own distance from fp32
    for key in ("prefill_vs_forward_fp32", "decode_vs_forward_fp32"):
        require(math.isfinite(checks[key]) and checks[key] <= 1e-3,
                f"{tag}: {key} {checks[key]:.3e} > 1e-3")
    lim16 = 2 * checks["forward_bf16_vs_fp32"]
    for key in ("prefill_vs_forward_bf16", "decode_vs_forward_bf16"):
        require(math.isfinite(checks[key]) and checks[key] <= lim16,
                f"{tag}: {key} {checks[key]:.3e} > {lim16:.3e} (twice the "
                "bf16 forward's distance from fp32)")

    if on_card:
        out["host_syncs"] = decode_syncs(torch, M, cfg, eng)
        log(f"{tag} (d) host syncs (torch.cuda.set_sync_debug_mode):",
            json.dumps(out["host_syncs"]))
        require(out["host_syncs"]["decode_step_raised"] is None,
                f"{tag}: the decode step synchronized the host: "
                f"{out['host_syncs']['decode_step_raised']}")
        out["profile"] = profile_engine(torch, np, TS, cfg, comp, "auto",
                                        sizes)
        log(f"{tag} (e) device time by kernel:", json.dumps(out["profile"]))
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# calibration policies and checkpoints (phase 4's adaptive runs, phase 11)


class _GapCapture:
    """Collects the allocator's smallest relative λ gap (the ``lambda_gap``
    record ``core.pipeline._allocate_ranks`` logs) while it is entered."""

    def __enter__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                gap = getattr(record, "lambda_gap", None)
                if gap is not None:
                    self.gaps.append(gap)

        self.gaps = []
        self._logger = logging.getLogger("repro_torch.core.pipeline")
        self._level = self._logger.level
        self._handler = Handler(logging.DEBUG)
        self._logger.addHandler(self._handler)
        self._logger.setLevel(logging.DEBUG)
        return self.gaps

    def __exit__(self, *exc):
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)


class _SolveSweepForwards:
    """Records the adaptive solve sweep's own tapped forwards (its report's
    count before ``_merge_adaptive_report`` folds the estimate sweep's
    in) while it is entered."""

    def __enter__(self):
        from repro_torch.core import pipeline as P
        self.P, self.merge, self.counts = P, P._merge_adaptive_report, []

        def spy(report, rep1, est, alloc):
            self.counts.append(report["calibration"]["tapped_forwards"])
            self.merge(report, rep1, est, alloc)

        P._merge_adaptive_report = spy
        return self.counts

    def __exit__(self, *exc):
        self.P._merge_adaptive_report = self.merge


def adaptive_checks(P, R, cfg, ccfg, report, n_microbatches, tag):
    """The allocation's invariants and the forward law, from a report:
    the budget met within one lane step (the largest copies · rank cost ·
    rank_multiple of any linear), unit 0 never replayed with drift 0, and
    2·B + 2·R·B tapped forwards a unit.  Returns the summary it logs."""
    alloc = report["calibration"]["rank_mode"]
    lane = max((lin["shape"][0] if len(lin["shape"]) == 3
                and "rank_per_expert" not in lin else 1)
               * R.rank_cost(lin["shape"][-1], lin["shape"][-2],
                             remap=ccfg.remap) * ccfg.rank_multiple
               for u in report["units"] for lin in u["linears"])
    slack = alloc["budget_params"] - alloc["allocated_params"]
    require(0 <= slack <= lane, f"{tag}: budget {alloc['budget_params']} "
            f"allocated {alloc['allocated_params']} (one lane step {lane})")
    first = report["units"][0]
    require(first["replay_taps"] == [] and all(
        v == 0.0 for v in first["shift_drift"].values()),
        f"{tag}: unit 0 replayed {first['replay_taps']} or drifted "
        f"{first['shift_drift']}")
    b = n_microbatches
    for u in report["units"]:
        want = 2 * b + 2 * len(u["replay_taps"]) * b
        require(u["tapped_forwards"] == want, f"{tag}: {u['name']} "
                f"tapped {u['tapped_forwards']} forwards, not {want}")
    return {"alloc": alloc, "lane_step_params": lane,
            "budget_slack_params": slack}


def kept_triple_bytes(P, cfg, report):
    """Bytes of the covariance triples the estimate sweep keeps: three
    fp32 (n, n) per tap group, (E, n, n) for an expert bank."""
    total = 0
    for u in report["units"]:
        shapes = {lin["path"]: lin["shape"] for lin in u["linears"]}
        for _, group in P.tap_groups(P.linear_specs(u["kind"], cfg)):
            shape = shapes[group[0].path]
            experts = shape[0] if group[0].bank else 1
            total += 3 * experts * shape[-2] ** 2 * 4
    return total


def _replayed_map_error(torch, comp_a, comp_b, report_b, cfg):
    """Worst relative error of comp_a's composed maps against comp_b's, a
    dense stacked stage (llama).  A tap group the unit replayed saw a
    shifted stream that is rank-deficient by construction (``attn/o_in``
    mixes the compressed ``wv``'s values), so there the maps are compared
    as they act on it: ||X′(A − B)||_F / ||X′ B||_F from comp_b's X′ᵀX′
    (``debug_covs``)."""
    from repro_torch.core import pipeline as P
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(_factor_pairs(comp_a["stages"]),
                                 _factor_pairs(comp_b["stages"])):
        lin = ".".join(path.split(".")[-2:])
        maps = [torch.einsum("lnk,lkm->lnm", f["v"].cpu().double(),
                             f["u"].cpu().double()) for f in (a, b)]
        for layer, unit in enumerate(report_b["units"]):
            tap = next(s.tap for s in P.linear_specs(unit["kind"], cfg)
                       if s.path == lin)
            dw, w = maps[0][layer] - maps[1][layer], maps[1][layer]
            if tap in unit["replay_taps"]:
                lam, q = torch.linalg.eigh(
                    unit["covs"][tap]["xpxp"].cpu().double())
                half = q * lam.clamp(min=0.0).sqrt()[None, :]
                dw, w = half.T @ dw, half.T @ w
            err = float(torch.linalg.norm(dw) / torch.linalg.norm(w))
            if err > worst:
                worst, where = err, f"{lin} [{layer}]"
    return worst, where


def phase_smoke_adaptive(torch, np, dev="cuda"):
    """llama smoke (fp32) compressed with ``rank_mode="adaptive"``,
    ``calib_mode="hybrid"`` and ``replay_taps="auto"`` on the card and on
    the CPU from the same params and 8 × 32 uniform tokens: ranks and
    replay taps equal, composed maps to 1e-3 (replayed groups on their
    shifted stream).  Then the card's compression saved, restored onto the
    card with ``restore_tree`` (every leaf bit for bit) and served by
    ``Server.from_checkpoint``: the same tokens as the in-memory
    ``Server``."""
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pipeline as P
    from repro_torch.core import ranks as R
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M
    from repro_torch.tree import flatten

    cfg = configs.get_smoke_config("llama-7b").replace(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    calib = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32))}
    recipe = P.CompressConfig(ratio=0.6, microbatch=2, refine_epochs=1,
                              calib_mode="hybrid", replay_taps="auto",
                              rank_mode="adaptive", debug_covs=True)
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        with _GapCapture() as gaps:
            comp, rep = P.compress_model(params, cfg, calib, recipe,
                                         device=d)
        out[name] = (comp, rep, gaps[0])
    ranks = {run: [[lin["rank"] for lin in u["linears"]]
                   for u in out[run][1]["units"]] for run in out}
    replays = {run: [u["replay_taps"] for u in out[run][1]["units"]]
               for run in out}
    worst, where = _replayed_map_error(torch, out["card"][0],
                                       out["cpu"][0], out["cpu"][1], cfg)
    tag = "smoke adaptive"
    log(f"{tag}: ranks card {ranks['card']} cpu {ranks['cpu']}; replay taps "
        f"card {replays['card']} cpu {replays['cpu']}; composed-map rel err "
        f"{worst:.3e} at {where}; smallest relative lambda gap card "
        f"{json.dumps(out['card'][2])} cpu {json.dumps(out['cpu'][2])}; "
        f"allocation {json.dumps(out['card'][1]['calibration']['rank_mode'])}")
    require(ranks["card"] == ranks["cpu"], f"{tag}: ranks differ")
    require(replays["card"] == replays["cpu"], f"{tag}: replay taps differ")
    require(worst <= 1e-3, f"{tag}: composed maps differ by {worst:.3e}")
    checks = adaptive_checks(P, R, cfg, recipe, out["card"][1], 4, tag)

    # the card's compression through a checkpoint
    comp = out["card"][0]
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, 24), dtype=np.int32)
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d, async_save=False).save(0, comp,
                                                    meta={"tag": tag})
        _, back, meta = CheckpointManager(d, async_save=False).restore_tree(
            0, device=dev)
        leaves, tdef = flatten(comp)
        back_leaves, back_tdef = flatten(back)
        same = tdef == back_tdef and all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in zip(leaves, back_leaves))
        srv = TS.Server.from_checkpoint(cfg, d, max_len=48, batch=4,
                                        device=dev)
        got = srv.generate(prompts, steps=8).cpu().tolist()
    want = TS.Server(cfg, comp, max_len=48, batch=4,
                     device=dev).generate(prompts, steps=8).cpu().tolist()
    log(f"{tag}: checkpoint round trip on the card, {len(leaves)} leaves "
        f"bit for bit {same}; meta {meta}; Server.from_checkpoint tokens "
        f"{json.dumps(got)} in-memory {json.dumps(want)}")
    require(same, f"{tag}: restored leaves differ from the saved ones")
    require(got == want and srv.checkpoint_meta == {"tag": tag},
            f"{tag}: Server.from_checkpoint tokens differ")
    return {"ranks": ranks["card"], "replay_taps": replays["card"],
            "map_rel_err": worst, "map_worst_at": where,
            "lambda_gap": {k: out[k][2] for k in out},
            "checks": checks, "checkpoint_leaves": len(leaves),
            "checkpoint_bitwise": same, "tokens": got}


def phase_smoke_moe_adaptive(torch, np, dev="cuda"):
    """deepseek-v2-lite smoke (fp32, 2 layers) compressed under the
    drop-free dispatch with ``rank_mode="adaptive"`` (``rank_multiple=1``:
    per-expert ranks spread) on the card and on the CPU from the same
    params and 16 × 64 uniform tokens: the routed ids exactly equal, the
    banks' ``rank_per_expert`` tuples equal."""
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = _dropfree(configs.get_smoke_config("deepseek-v2-lite-16b").replace(
        dtype="float32"))
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    calib = {"tokens": rng.integers(0, cfg.vocab_size, (16, 64))}
    recipe = P.CompressConfig(ratio=0.6, rank_multiple=1, microbatch=2,
                              calib_mode="fused", refine_epochs=1,
                              moe_dispatch="dropfree", rank_mode="adaptive")
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        store = {}
        pd = tree_map(lambda x, d=d: x.to(d), params)
        with torch.no_grad(), L.sowing(store):
            M.forward_hidden(pd, cfg, {"tokens": torch.from_numpy(
                calib["tokens"]).to(d)})
        ids = _routed_ids(torch, L, store, pd, cfg)
        with _GapCapture() as gaps:
            _, rep = P.compress_model(params, cfg, calib, recipe, device=d)
        per_expert = [lin["rank_per_expert"] for u in rep["units"]
                      for lin in u["linears"] if "rank_per_expert" in lin]
        out[name] = (per_expert, ids, rep, gaps[0])
    flips = int((out["card"][1] != out["cpu"][1]).sum())
    tag = "smoke moe adaptive (dropfree)"
    log(f"{tag}: rank_per_expert card {out['card'][0]} cpu "
        f"{out['cpu'][0]}; routed ids {tuple(out['cpu'][1].shape)} flips "
        f"{flips}; smallest relative lambda gap card "
        f"{json.dumps(out['card'][3])} cpu {json.dumps(out['cpu'][3])}; "
        f"allocation {json.dumps(out['card'][2]['calibration']['rank_mode'])}")
    require(flips == 0, f"{tag}: {flips} routed ids differ")
    require(len(out["card"][0]) == 3 and out["card"][0] == out["cpu"][0],
            f"{tag}: rank_per_expert differ")
    require(any(len(set(ks)) > 1 for ks in out["card"][0]),
            f"{tag}: every expert of every bank got one rank")
    return {"rank_per_expert": out["card"][0], "id_flips": flips,
            "lambda_gap": {k: out[k][3] for k in out},
            "alloc": out["card"][2]["calibration"]["rank_mode"]}


def _dir_bytes(path):
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def phase_policies(torch, np, ops, dev="cuda", sizes=SIZES, cfg=None,
                   uniform=None):
    """Phase 11 (a): phase 5's llama-7b configuration, weights, data and
    recipe, compressed with ``rank_mode="adaptive"``, ``calib_mode=
    "hybrid"`` and ``replay_taps="auto"``; saved with the port's
    ``CheckpointManager``, restored onto the card by
    ``Server.from_checkpoint`` / ``ContinuousBatchingServer
    .from_checkpoint`` and served at phase 6's shapes, tokens bit for bit
    the in-memory model's.  ``uniform``: phase 5's compressed eval losses,
    printed beside this one's."""
    import tempfile

    import repro_torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pipeline as P
    from repro_torch.core import ranks as R
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    layers = sizes["layers"]
    if cfg is None:
        cfg = configs.get_config("llama-7b")
    cfg = cfg.replace(num_layers=layers)
    tag = "policies"
    # phase 5's weights and data: the same seeds, drawn in the same order
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(
        ratio=0.6, calib_mode="hybrid", replay_taps="auto",
        rank_mode="adaptive", refine_epochs=1,
        microbatch=sizes["microbatch"])
    log(f"{tag}: llama-7b widths, num_layers 32 -> {layers}, phase 5's "
        f"weights and data; {json.dumps({k: getattr(ccfg, k) for k in ('ratio', 'calib_mode', 'replay_taps', 'drift_threshold', 'rank_mode', 'rank_multiple', 'rank_floor_ratio', 'refine_epochs', 'microbatch')})}")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    with _GapCapture() as gaps, _SolveSweepForwards() as solve_forwards:
        comp, report = repro_torch.compress_model(
            params, cfg, calib, ccfg, device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    with torch.no_grad():
        loss = [float(M.loss_fn(comp, cfg, b)[0]) for b in evals]
    n_mb = -(-sizes["calib"][0] // sizes["microbatch"])
    checks = adaptive_checks(P, R, cfg, ccfg, report, n_mb, tag)
    kept = kept_triple_bytes(P, cfg, report)
    alloc = report["calibration"]["rank_mode"]
    log(f"{tag}: allocation min_rank {alloc['min_rank']} max_rank "
        f"{alloc['max_rank']} achieved_ratio {alloc['achieved_ratio']} "
        f"allocated_params {alloc['allocated_params']} budget_params "
        f"{alloc['budget_params']} (slack {checks['budget_slack_params']},"
        f" one lane step {checks['lane_step_params']}); smallest relative "
        f"lambda gap {json.dumps(gaps)}")
    for u in report["units"]:
        log(f"{tag}: {u['name']} ranks (uniform) "
            + ", ".join(f"{lin['path']} {lin['rank']} ({lin['uniform_rank']})"
                        for lin in u["linears"])
            + f"; shift_drift {json.dumps(u['shift_drift'])}; replay_taps "
            f"{u['replay_taps']}; tapped_forwards {u['tapped_forwards']}; "
            f"pre/post-refine mse {u['pre_refine_mse']:.6e} / "
            f"{u['post_refine_mse']:.6e}")
    log(f"{tag}: stage seconds (both sweeps; estimate.* the estimate "
        f"sweep's)", json.dumps(stages))
    log(f"{tag}: compress wall {t_compress:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB, kept triples {kept / 2**30:.3f} GiB "
        f"({kept} B), solve sweep tapped forwards {solve_forwards}; "
        f"launches {json.dumps(launches)}")
    log(f"{tag}: eval loss adaptive {loss} uniform (phase 5) {uniform}")
    require(solve_forwards == [0], f"{tag}: the solve sweep issued "
            f"{solve_forwards} tapped forwards")
    require(all(math.isfinite(v) for v in loss), f"{tag}: loss {loss}")
    for name in ("cov_accum", "lowrank_matmul", "flash_attention",
                 "flash_attention_bwd"):
        require(launches[name] > 0, f"{tag}: {name} never launched")

    out = {"stages": stages, "compress_wall_s": t_compress,
           "peak_bytes": peak, "kept_triple_bytes": kept,
           "launches": launches, "lowrank_rows": lowrank_rows(ops),
           "flash_bodies": dict(ops.FLASH_BODIES), "lambda_gap": gaps,
           "checks": checks, "loss": loss, "uniform_loss": uniform,
           "ranks": {u["name"]: {lin["path"]: [lin["rank"],
                                               lin["uniform_rank"]]
                                 for lin in u["linears"]}
                     for u in report["units"]},
           "shift_drift": {u["name"]: u["shift_drift"]
                           for u in report["units"]},
           "replay_taps": {u["name"]: u["replay_taps"]
                           for u in report["units"]},
           "tapped_forwards": {u["name"]: u["tapped_forwards"]
                               for u in report["units"]}}
    attn = comp["stages"][0][0]["attn"]
    out["r_k_r_v"] = [int(attn["wk"]["v"].shape[-1]),
                      int(attn["wv"]["v"].shape[-1])]

    rng = np.random.default_rng(7)
    b, plen, steps, max_len = sizes["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    slots, e_len, chunk, n_req, (lo, hi), e_steps = sizes["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=e_steps) for i, n in enumerate(lens)]
    with tempfile.TemporaryDirectory() as d:
        _sync(torch, dev)
        t0 = time.perf_counter()
        CheckpointManager(d, async_save=False).save(
            0, comp, meta={"arch": "llama-7b", "layers": layers})
        out["save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = _dir_bytes(d)
        t0 = time.perf_counter()
        _, back, _ = CheckpointManager(d, async_save=False).restore_tree(
            0, device=dev)
        _sync(torch, dev)
        out["restore_s"] = time.perf_counter() - t0
        pairs = list(zip(_factor_pairs(comp), _factor_pairs(back)))
        require(pairs and all(torch.equal(a[key], b_[key])
                              for (_, a), (_, b_) in pairs
                              for key in ("u", "v")),
                f"{tag}: restored factors differ from the saved ones")
        del back
        srv = TS.Server(cfg, comp, max_len=max_len, batch=b, device=dev)
        want = srv.generate(prompts, steps=steps).cpu()
        del srv
        ops.reset_launches()
        t0 = time.perf_counter()
        srv = TS.Server.from_checkpoint(cfg, d, max_len=max_len, batch=b,
                                        device=dev)
        got = srv.generate(prompts, steps=steps).cpu()
        out["server"] = {"wall_s": time.perf_counter() - t0,
                         "launches": dict(ops.LAUNCHES),
                         "tokens_equal": bool(torch.equal(got, want)),
                         "meta": srv.checkpoint_meta}
        del srv
        eng = TS.ContinuousBatchingServer(cfg, comp, max_len=e_len,
                                          slots=slots, prefill_chunk=chunk,
                                          device=dev)
        want_e = eng.run(reqs)
        del eng
        ops.reset_launches()
        t0 = time.perf_counter()
        eng = TS.ContinuousBatchingServer.from_checkpoint(
            cfg, d, max_len=e_len, slots=slots, prefill_chunk=chunk,
            device=dev)
        got_e = eng.run(reqs)
        out["engine"] = {
            "wall_s": time.perf_counter() - t0,
            "launches": dict(ops.LAUNCHES),
            "lowrank_rows": lowrank_rows(ops),
            "decode_bodies": dict(ops.DECODE_BODIES),
            "decode_step_ms_median": statistics.median(
                eng.decode_step_times) * 1e3,
            "tokens_equal": all(np.array_equal(got_e[i]["tokens"],
                                               want_e[i]["tokens"])
                                for i in range(n_req))}
        del eng
    log(f"{tag}: checkpoint {out['checkpoint_bytes']} B, save "
        f"{out['save_s']:.3f} s, restore onto the card "
        f"{out['restore_s']:.3f} s; r_k / r_v {out['r_k_r_v']}")
    log(f"{tag}: Server.from_checkpoint", json.dumps(out["server"]))
    log(f"{tag}: ContinuousBatchingServer.from_checkpoint",
        json.dumps(out["engine"]))
    require(out["server"]["tokens_equal"], f"{tag}: Server.from_checkpoint "
            "tokens differ from the in-memory model's")
    require(out["engine"]["tokens_equal"], f"{tag}: the engine's "
            "from_checkpoint tokens differ from the in-memory model's")
    require(out["engine"]["launches"]["flash_decode"] > 0,
            f"{tag}: flash_decode never launched by the restored engine")
    return out


def phase_policies_moe(torch, ops, dev="cuda", sizes=SIZES, cfg=None,
                       uniform=None):
    """Phase 11 (b): phase 8's deepseek-v2-lite configuration (its own
    capacity dispatch), weights and data, compressed with
    ``calib_mode="hybrid"`` and the static replay list (the expert banks)
    at uniform ranks.  ``uniform``: phase 8's compressed eval CEs."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    layers = sizes["moe_layers"]
    if cfg is None:
        cfg = configs.get_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(num_layers=layers)
    tag = "policies moe"
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="hybrid",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    with torch.no_grad():
        ce = [float(M.loss_fn(comp, cfg, b)[1]["ce"]) for b in evals]
    n_mb = -(-sizes["calib"][0] // sizes["microbatch"])
    rates = report["calibration"]["moe_drop_rate"]
    log(f"{tag}: deepseek-v2-lite widths, num_layers 27 -> {layers}, "
        f"dispatch {cfg.moe.dispatch} (capacity factor "
        f"{cfg.moe.capacity_factor}), calib_mode hybrid (static replay); "
        f"wall {wall:.3f} s, stage seconds {json.dumps(stages)}, peak "
        f"{peak / 2**30:.3f} GiB; launches {json.dumps(launches)}; drop "
        f"rates {json.dumps(rates)}")
    for u in report["units"]:
        log(f"{tag}: {u['name']} replay_taps {u['replay_taps']} "
            f"tapped_forwards {u['tapped_forwards']} shift_drift "
            f"{json.dumps(u['shift_drift'])}")
    log(f"{tag}: eval CE hybrid {ce} fused (phase 8) {uniform}")
    for u in report["units"]:
        want_taps = (["ffn/experts_in", "ffn/experts_down_in"]
                     if u["kind"].endswith("_moe") else [])
        require(u["replay_taps"] == want_taps, f"{tag}: {u['name']} "
                f"replayed {u['replay_taps']}, not {want_taps}")
        want = 2 * n_mb + 2 * len(want_taps) * n_mb
        require(u["tapped_forwards"] == want, f"{tag}: {u['name']} tapped "
                f"{u['tapped_forwards']} forwards, not {want}")
    require(launches["cov_accum_banked"] > 0,
            f"{tag}: cov_accum_banked never launched")
    require(launches["grouped_matmul"] == 0,
            f"{tag}: grouped_matmul launched on the capacity path")
    require(all(math.isfinite(v) for v in ce), f"{tag}: CE {ce}")
    require(rates and all(0.0 <= r < 1.0 for r in rates.values()),
            f"{tag}: drop rates {rates}")
    return {"wall_s": wall, "stages": stages, "peak_bytes": peak,
            "launches": launches, "lowrank_rows": lowrank_rows(ops),
            "flash_bodies": dict(ops.FLASH_BODIES), "drop_rates": rates,
            "replay_taps": {u["name"]: u["replay_taps"]
                            for u in report["units"]},
            "tapped_forwards": {u["name"]: u["tapped_forwards"]
                                for u in report["units"]},
            "ce": ce, "uniform_ce": uniform}


# ---------------------------------------------------------------------------
# phase 12: kimi-k2 at its published widths (GQA attention over a MoE)


def phase_kimi(torch, np, ops, dev="cuda", sizes=SIZES, cfg=None):
    """kimi-k2 at published widths (d_model 7168, 64 query heads on 8 KV
    heads of head dim 112, dense FFN 18432, expert d_ff 2048, top-8, one
    shared expert, vocab 163840, its own capacity dispatch at factor 1.25),
    depth cut 61 -> ``kimi_layers`` (one ``attn_dense_first``, then
    ``attn_moe``) and routed experts 384 -> ``kimi_experts``, random weights:
    phase 5's recipe, then the compressed model served at phase 6's shapes:
    (a) ``Server`` over the dense cache (``flash_attention`` zero-padded to
    head dim 128: wgmma prefill, split decode), (b) the engine over the
    latent cache (``flash_decode`` at head dim 112, every launch in the
    wgmma body), (b') the engine over the dense cache, (c) one
    teacher-forced sequence decoded over both caches, (d) the decode
    step's host syncs, (e) a profiled engine run.  Counts zeroed before
    each run and read after."""
    import dataclasses

    import repro_torch
    from repro_torch import configs
    from repro_torch.launch import serve as TS
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    if cfg is None:
        cfg = configs.get_config("kimi-k2-1t-a32b")
    full = (cfg.num_layers, cfg.moe.num_experts)
    layers, experts = sizes["kimi_layers"], sizes["kimi_experts"]
    cfg = cfg.replace(num_layers=layers, moe=dataclasses.replace(
        cfg.moe, num_experts=experts))
    tag = "kimi"
    program = [(st.kinds, st.n) for st in B.stage_program(cfg)]
    log(f"{tag}: kimi-k2 widths d_model {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim {cfg.head_dim} dense "
        f"d_ff {cfg.moe.dense_d_ff} expert d_ff {cfg.moe.d_ff} top-"
        f"{cfg.moe.top_k} shared {cfg.moe.num_shared_experts} vocab "
        f"{cfg.vocab_size} rope theta {cfg.rope_theta}, dispatch "
        f"{cfg.moe.dispatch} (capacity factor {cfg.moe.capacity_factor}), "
        f"dtype {cfg.dtype} params {cfg.param_dtype}; num_layers cut "
        f"{full[0]} -> {layers}, routed experts {full[1]} -> {experts} for "
        f"one card's memory; stages {program}")
    kinds = [k for kk, _ in program for k in kk]
    require(kinds == ["attn_dense_first", "attn_moe"],
            f"{tag}: sub-block kinds {kinds}")
    # head dim 112 has its own bodies: the kernel reads q, k, v unpadded
    dk = ops._padded_head_dim(cfg.head_dim)
    require(dk == cfg.head_dim, f"{tag}: head dim {cfg.head_dim} pads to "
            f"{dk}")
    out = {"layers": layers, "experts": experts, "kernel_head_dim": dk,
           "program": [[list(k), n] for k, n in program]}

    # compression (phase 5's recipe, the config's own capacity dispatch)
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="fused",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"])

    def eval_ce(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[1]["ce"]) for b in evals]

    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = eval_ce(params)
    compressed = eval_ce(comp)
    stages["eval"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ratio = repro_torch.compress_ratio_report(params, comp)
    del params
    ranks = {}
    for u in report["units"]:
        ranks.update({lin["path"]: lin["rank"] for lin in u["linears"]})
    rates = report["calibration"]["moe_drop_rate"]
    out["compress"] = {
        "stages": stages, "wall_s": t_compress, "peak_bytes": peak,
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": bodies, "ratio": ratio, "ranks": ranks,
        "drop_rates": rates, "dense": dense, "compressed": compressed,
        "units": [[u["name"], u["pre_refine_mse"], u["post_refine_mse"]]
                  for u in report["units"]]}
    log(f"{tag}: compress", json.dumps(out["compress"]))
    log(f"{tag}: compress wall {t_compress:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB; eval CE dense {dense} compressed "
        f"{compressed}")
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u["pre_refine_mse"],
                                           u["post_refine_mse"])]
    require(all(math.isfinite(v) for v in vals), f"{tag}: non-finite {vals}")
    require(rates and all(0.0 <= r < 1.0 for r in rates.values()),
            f"{tag}: drop rates {rates} outside [0, 1)")
    for name in ("cov_accum", "cov_accum_banked", "lowrank_matmul",
                 "flash_attention", "flash_attention_bwd"):
        require(launches[name] > 0,
                f"{tag}: kernel {name} never launched on compression")
    require(launches["grouped_matmul"] == 0, f"{tag}: grouped_matmul "
            f"launched {launches['grouped_matmul']} times under capacity")
    require(not on_card or bodies.get("wgmma", 0) > 0,
            f"{tag}: flash_attention's wgmma body never taken: {bodies}")
    want_ranks = {"attn.wq": 2152, "attn.wk": 480, "attn.wv": 480,
                  "attn.wo": 2152, "ffn.gate": 3096, "ffn.down": 3096,
                  "ffn.experts.gate": 960, "ffn.experts.down": 960,
                  "ffn.shared.gate": 960, "ffn.shared.down": 960}
    if cfg.d_model == 7168:     # the published widths (ratio 0.6, lanes 8)
        require(all(ranks.get(k) == v for k, v in want_ranks.items()),
                f"{tag}: ranks {ranks} differ from {want_ranks}")
    if on_card:
        torch.cuda.empty_cache()

    def gates(run, launches, bodies, decode_bodies, latent):
        require(launches["lowrank_matmul"] > 0,
                f"{tag} {run}: lowrank_matmul never launched")
        require(launches["flash_attention"] > 0,
                f"{tag} {run}: flash_attention never launched")
        require(launches["grouped_matmul"] == 0,
                f"{tag} {run}: grouped_matmul launched under capacity")
        if latent:
            require(launches["flash_decode"] > 0,
                    f"{tag} {run}: flash_decode never launched")
            require(not on_card or (decode_bodies.get("wgmma", 0)
                                    == launches["flash_decode"]),
                    f"{tag} {run}: flash_decode outside its wgmma body: "
                    f"{decode_bodies}")
        else:
            require(launches["flash_decode"] == 0,
                    f"{tag} {run}: flash_decode launched over a dense cache")
            # every dense-cache decode (64 query heads on 8, bf16) takes
            # the tensor-core GQA body
            require(not on_card or (bodies.get("split_mma", 0) > 0
                                    and bodies.get("split", 0) == 0),
                    f"{tag} {run}: decode outside the split_mma body: "
                    f"{bodies}")

    # (a) fixed batch over the dense cache
    rng = np.random.default_rng(29)
    b, plen, steps, max_len = sizes["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    srv = TS.Server(cfg, comp, max_len=max_len, batch=b, device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    first = srv.generate(prompts, steps=1).cpu()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, steps=steps).cpu()
    t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gates("Server", launches, bodies, dict(ops.DECODE_BODIES), False)
    require(tuple(toks.shape) == (b, steps) and torch.equal(toks[:, :1],
                                                            first)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{tag}: Server tokens malformed: {tuple(toks.shape)}")
    decode_s = t_all - t_prefill
    out["server"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": bodies, "ttft_s": t_prefill,
        "prefill_tokens_per_s": b * plen / t_prefill,
        "decode_tokens_per_s": b * (steps - 1) / decode_s,
        "decode_step_ms": decode_s / (steps - 1) * 1e3,
        "generate_s": t_all, "peak_bytes": peak,
        "tokens_head": toks[:, :8].tolist()}
    log(f"{tag} (a) Server dense cache:", json.dumps(out["server"]))
    del srv

    # (b) continuous batching over the latent cache, (b') over the dense one
    slots, max_len, chunk, n_req, (lo, hi), steps = sizes["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=steps) for i, n in enumerate(lens)]
    results = {}
    for key, layout in (("engine", "auto"), ("engine_dense", "dense")):
        eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                          slots=slots, prefill_chunk=chunk,
                                          cache_layout=layout, device=dev)
        _sync(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(reqs)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        bodies = dict(ops.FLASH_BODIES)
        decode_bodies = dict(ops.DECODE_BODIES)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        latent = layout == "auto"
        gates(key, launches, bodies, decode_bodies, latent)
        require(sorted(res) == list(range(n_req)) and all(
            len(r["tokens"]) == steps
            and ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size)).all()
            for r in res.values()), f"{tag} {key}: results malformed")
        require(set(eng.prefill_routes.values()) == {"chunked"},
                f"{tag} {key}: prefill routes {eng.prefill_routes}")
        ttft = [res[i]["first_token"] - res[i]["arrival"]
                for i in range(n_req)]
        prefill_s = [res[i]["first_token"] - res[i]["admitted"]
                     for i in range(n_req)]
        times = eng.decode_step_times
        cache = _cache_bytes(M, cfg, slots, max_len, eng._cache_params)
        out[key] = {
            "launches": launches, "lowrank_rows": lowrank_rows(ops),
            "flash_bodies": bodies, "decode_bodies": decode_bodies,
            "wall_s": wall, "requests": n_req, "prompt_lens": lens.tolist(),
            "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
            "prefill_tokens_per_s": float(sum(lens)) / sum(prefill_s),
            "decode_steps": len(times),
            "decode_step_ms_median": statistics.median(times) * 1e3,
            "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
            "cache_bytes": cache,
            "cache_bytes_per_token_layer": cache / (slots * max_len * layers),
            "peak_bytes": peak}
        results[key] = res
        if latent:
            eng_latent = eng
        label = "(b) engine latent" if latent else "(b') engine dense"
        log(f"{tag} {label} cache:", json.dumps(out[key]))
    same = sum(int((results["engine_dense"][i]["tokens"]
                    == results["engine"][i]["tokens"]).sum())
               for i in range(n_req))
    out["engine_dense"]["tokens_equal_to_latent"] = same / (n_req * steps)
    eb = 2 if cfg.dtype == "bfloat16" else 4
    per_tok = {key: out[key]["cache_bytes_per_token_layer"]
               for key in ("engine", "engine_dense")}
    out["cache"] = {
        "latent_bytes_per_token_layer": per_tok["engine"],
        "dense_bytes_per_token_layer": per_tok["engine_dense"],
        "latent_share": per_tok["engine"] / per_tok["engine_dense"],
        "ranks_k_v": [ranks["attn.wk"], ranks["attn.wv"]]}
    log(f"{tag}: cache bytes a token a layer", json.dumps(out["cache"]))
    require(per_tok["engine_dense"] == 2 * cfg.num_kv_heads * cfg.head_dim
            * eb, f"{tag}: dense cache {per_tok['engine_dense']} B a token "
            "a layer")
    require(per_tok["engine"] == (ranks["attn.wk"] + ranks["attn.wv"]) * eb,
            f"{tag}: latent cache {per_tok['engine']} B a token a layer")

    # (c) one teacher-forced sequence decoded over the latent and the dense
    # cache, with bf16 and with fp32 activations
    plen, n_dec, max_len = sizes["serve_check"]
    p = eng_latent.params
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen + n_dec),
                                        dtype=np.int32)).to(dev)
    logits = {}
    with torch.inference_mode():
        for act in ("bfloat16", "float32"):
            c = cfg.replace(dtype=act)
            for layout in ("latent", "dense"):
                cache = M.init_cache(c, 1, max_len, params=p if layout ==
                                     "latent" else None, device=dev)
                rows = [M.prefill(p, c, {"tokens": seq[:, :plen]}, cache)[0]]
                for i in range(plen, plen + n_dec):
                    pos = torch.tensor([i], dtype=torch.int32, device=dev)
                    rows.append(M.decode_step(p, c, cache, seq[:, i:i + 1],
                                              pos)[0])
                logits[f"{layout}_{act}"] = torch.cat(rows)
                del cache
    checks = {f"latent_vs_dense_decode_{act}": rel_fro(
        logits[f"latent_{act}"][1:], logits[f"dense_{act}"][1:])
        for act in ("bfloat16", "float32")}
    checks["bf16_vs_fp32_decode"] = {
        layout: rel_fro(logits[f"{layout}_bfloat16"][1:],
                        logits[f"{layout}_float32"][1:])
        for layout in ("latent", "dense")}
    del logits
    out["checks"] = checks
    log(f"{tag} (c) checks (rel Frobenius):", json.dumps(checks))
    # fp32 activations: one function through flash_decode (keys up-projected
    # on chip) and through flash_attention over stored keys, sums in another
    # order: 1e-4, as phase 6.  bf16 is printed, not gated: the dense cache
    # stores bf16 keys and the latent one fp32-exact ones, so the router's
    # inputs differ by bf16 rounding and a top-8 choice may flip, an O(1)
    # move of one token's MoE output
    key = "latent_vs_dense_decode_float32"
    require(math.isfinite(checks[key]) and checks[key] <= 1e-4,
            f"{tag}: {key} {checks[key]:.3e} > 1e-4")

    if on_card:
        out["host_syncs"] = decode_syncs(torch, M, cfg, eng_latent)
        log(f"{tag} (d) host syncs (torch.cuda.set_sync_debug_mode):",
            json.dumps(out["host_syncs"]))
        require(out["host_syncs"]["decode_step_raised"] is None,
                f"{tag}: the decode step synchronized the host: "
                f"{out['host_syncs']['decode_step_raised']}")
        out["profile"] = profile_engine(torch, np, TS, cfg, comp, "auto",
                                        sizes)
        log(f"{tag} (e) device time by kernel:", json.dumps(out["profile"]))
    return out


# ---------------------------------------------------------------------------
# phase 13: the SSM family at published widths (zamba2-7b, falcon-mamba-7b)


def ssm_cache_bytes(M, B, cfg, slots, max_len, params):
    """Bytes of the engine's cache by kind: a mamba layer's state per slot
    ({"h", "conv"} each), an attention site's bytes a token, from the
    cache's own shapes (allocated on the ``meta`` device)."""
    cache = M.init_cache(cfg, slots, max_len, params=params, device="meta")
    out = {}
    for st, per_kind in zip(B.stage_program(cfg), cache):
        sites = st.n if (st.scan and st.n > 1) else 1
        for kind, c in zip(st.kinds, per_kind):
            if kind in B.SSM_KINDS:
                out[kind] = {key: t.numel() * t.element_size()
                             // (sites * slots) for key, t in c.items()}
            else:
                out[kind] = {"layout": "latent" if "lk" in c else "dense",
                             "per_token": sum(
                                 t.numel() * t.element_size()
                                 for t in c.values())
                             // (sites * slots * max_len)}
    out["total"] = _cache_bytes(M, cfg, slots, max_len, params)
    return out


def phase_ssm(torch, np, ops, dev="cuda", sizes=SIZES, arch="zamba2-7b",
              cfg=None):
    """Phase 13.  (a) zamba2-7b at published widths (d_model 3584, Mamba2
    d_inner 7168 in 112 SSD heads of 64, state 64; the shared block's 32
    heads on 32 KV heads of head dim 112, d_ff 14336, vocab 32000), depth
    cut 81 -> ``zamba2_layers`` (two stacked groups of 6 ``mamba2`` + the
    shared block, then a one-layer ``mamba2`` remainder), random weights:
    phase 5's recipe (the shared block compressed at its first site and
    reused at its second), then served at phase 6's shapes: ``Server``
    over the dense cache, the engine over the latent cache
    (``flash_decode`` at head dim 112, one query head a KV head) and over
    the dense one (every request ``whole_exact``), cache bytes, one
    teacher-forced sequence decoded over both caches, the decode step's
    host syncs and a profiled engine run.  (b) falcon-mamba-7b (Mamba1,
    d_inner 8192, state 16, dt_rank 256, vocab 65024), depth cut 64 ->
    ``falcon_layers``: the same recipe, then ``Server``.  Counts zeroed
    before each run and read after."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.launch import serve as TS
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    hybrid = arch == "zamba2-7b"
    if cfg is None:
        cfg = configs.get_config(arch)
    full = cfg.num_layers
    layers = sizes["zamba2_layers" if hybrid else "falcon_layers"]
    cfg = cfg.replace(num_layers=layers)
    tag = "zamba2" if hybrid else "falcon"
    s = cfg.ssm
    program = [(st.kinds, st.n) for st in B.stage_program(cfg)]
    log(f"{tag}: {arch} widths d_model {cfg.d_model} d_inner "
        f"{s.expand * cfg.d_model} state {s.state_dim} conv {s.conv_width} "
        f"chunk {s.chunk} " + (f"SSD heads {s.expand * cfg.d_model // s.head_dim} "
                               f"of {s.head_dim}; shared block heads "
                               f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim "
                               f"{cfg.head_dim} d_ff {cfg.d_ff} every "
                               f"{cfg.hybrid_attn_every}" if hybrid else
                               f"dt_rank {s.dt_rank}")
        + f"; vocab {cfg.vocab_size}, dtype {cfg.dtype} params "
        f"{cfg.param_dtype}; num_layers cut {full} -> {layers}; stages "
        f"{program}")
    if hybrid:
        every = cfg.hybrid_attn_every
        groups, rem = divmod(layers, every)
        want_prog = [(("mamba2",) * every + ("shared_attn",), groups)] + (
            [(("mamba2",), rem)] if rem else [])
    else:
        want_prog = [(("mamba1",), layers)]
    require(program == want_prog, f"{tag}: stage program {program}")
    out = {"layers": layers, "program": [[list(k), n] for k, n in program]}

    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="fused",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"])

    def eval_ce(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[1]["ce"]) for b in evals]

    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    rows = lowrank_rows(ops)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    dense = eval_ce(params)
    compressed = eval_ce(comp)
    stages["eval"] = time.perf_counter() - t0
    ratio = repro_torch.compress_ratio_report(params, comp)
    eval_busy = (eval_busy_share(torch, M, cfg, comp, evals[0]) if on_card
                 else None)
    del params
    ranks = {}
    for u in report["units"]:
        ranks.update({lin["path"]: lin["rank"]
                      for lin in u.get("linears", [])})
    reused = [u for u in report["units"] if u.get("reused")]
    out["compress"] = {
        "stages": stages, "wall_s": t_compress, "peak_bytes": peak,
        "launches": launches, "lowrank_rows": rows, "flash_bodies": bodies,
        "ratio": ratio, "ranks": ranks, "dense": dense,
        "compressed": compressed, "reused": reused,
        "tapped_forwards": report["calibration"]["tapped_forwards"],
        "eval_busy": eval_busy,
        "units": [[u["name"], u.get("pre_refine_mse"),
                   u.get("post_refine_mse")] for u in report["units"]]}
    log(f"{tag}: compress", json.dumps(out["compress"]))
    log(f"{tag}: compress wall {t_compress:.3f} s (solve "
        f"{stages.get('solve', 0.0):.3f} s), peak device memory "
        f"{peak / 2**30:.3f} GiB; eval CE dense {dense} compressed "
        f"{compressed}; reused unit {json.dumps(reused)}")
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u.get("pre_refine_mse", 0.0),
                                           u.get("post_refine_mse", 0.0))]
    require(all(math.isfinite(v) for v in vals), f"{tag}: non-finite {vals}")
    need = ("cov_accum", "lowrank_matmul") + (
        ("flash_attention", "flash_attention_bwd") if hybrid else ())
    for name in need:
        require(launches[name] > 0,
                f"{tag}: kernel {name} never launched on compression")
    for name in ("grouped_matmul", "cov_accum_banked", "flash_decode") + (
            () if hybrid else ("flash_attention", "flash_attention_bwd")):
        require(launches[name] == 0, f"{tag}: {name} launched "
                f"{launches[name]} times on compression")
    if hybrid:
        require(not on_card or bodies.get("wgmma", 0) > 0,
                f"{tag}: flash_attention's wgmma body never taken: {bodies}")
        n_sites = layers // cfg.hybrid_attn_every
        names = [u["name"] for u in report["units"]]
        require(names.count("dec.shared.shared_attn") == 1
                and len(reused) == n_sites - 1
                and all(u["tapped_forwards"] == 0
                        and u["replayed_groups"] == 0 for u in reused),
                f"{tag}: shared-block units {names}, reused {reused}")
        want_ranks = {"mixer.in_proj": 1728, "mixer.out_proj": 1440,
                      "attn.wq": 1080, "attn.wk": 1080, "attn.wv": 1080,
                      "attn.wo": 1080, "ffn.gate": 1720, "ffn.up": 1720,
                      "ffn.down": 1720}
        published = cfg.d_model == 3584
    else:
        want_ranks = {"mixer.in_proj": 1968, "mixer.x_proj": 168,
                      "mixer.dt_proj": 152, "mixer.out_proj": 1640}
        published = cfg.d_model == 4096
    if published:     # the published widths (ratio 0.6, lanes 8)
        require(ranks == want_ranks,
                f"{tag}: ranks {ranks} differ from {want_ranks}")
    if on_card:
        torch.cuda.empty_cache()

    def gates(run, launches, bodies, decode_bodies, latent):
        require(launches["lowrank_matmul"] > 0,
                f"{tag} {run}: lowrank_matmul never launched")
        require(launches["grouped_matmul"] == 0,
                f"{tag} {run}: grouped_matmul launched")
        if not hybrid:
            require(launches["flash_attention"] == 0
                    and launches["flash_decode"] == 0,
                    f"{tag} {run}: attention kernels launched on an "
                    f"attention-free model: {launches}")
            return
        require(launches["flash_attention"] > 0,
                f"{tag} {run}: flash_attention never launched")
        if latent:
            require(launches["flash_decode"] > 0,
                    f"{tag} {run}: flash_decode never launched")
            require(not on_card or (decode_bodies.get("wgmma", 0)
                                    == launches["flash_decode"]),
                    f"{tag} {run}: flash_decode outside its wgmma body: "
                    f"{decode_bodies}")
        else:
            require(launches["flash_decode"] == 0,
                    f"{tag} {run}: flash_decode launched over a dense cache")
            require(not on_card or bodies.get("split", 0) > 0,
                    f"{tag} {run}: no decode in the split body: {bodies}")

    # (a) fixed batch (its cache built without params: dense)
    rng = np.random.default_rng(31)
    b, plen, steps, max_len = sizes["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    srv = TS.Server(cfg, comp, max_len=max_len, batch=b, device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    first = srv.generate(prompts, steps=1).cpu()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, steps=steps).cpu()
    t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gates("Server", launches, bodies, dict(ops.DECODE_BODIES), False)
    require(tuple(toks.shape) == (b, steps) and torch.equal(toks[:, :1],
                                                            first)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{tag}: Server tokens malformed: {tuple(toks.shape)}")
    decode_s = t_all - t_prefill
    out["server"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": bodies, "ttft_s": t_prefill,
        "prefill_tokens_per_s": b * plen / t_prefill,
        "decode_tokens_per_s": b * (steps - 1) / decode_s,
        "decode_step_ms": decode_s / (steps - 1) * 1e3,
        "generate_s": t_all, "peak_bytes": peak,
        "tokens_head": toks[:, :8].tolist()}
    if on_card:
        out["server"]["profile"] = busy_share(
            torch, lambda: srv.generate(prompts[:, :128], steps=16))
    log(f"{tag} (a) Server:", json.dumps(out["server"]))
    cache = ssm_cache_bytes(M, B, cfg, b, max_len, None)
    kind = "mamba2" if hybrid else "mamba1"
    di, eb = s.expand * cfg.d_model, 2 if cfg.dtype == "bfloat16" else 4
    if hybrid:
        want_state = {"h": di // s.head_dim * s.head_dim * s.state_dim * 4,
                      "conv": (s.conv_width - 1) * (di + 2 * s.state_dim)
                      * eb}
    else:
        want_state = {"h": di * s.state_dim * 4,
                      "conv": (s.conv_width - 1) * di * eb}
    require(cache[kind] == want_state, f"{tag}: {kind} state bytes a slot "
            f"{cache[kind]}, want {want_state}")
    out["cache"] = {"server": cache}
    del srv
    if not hybrid:
        log(f"{tag}: cache bytes", json.dumps(out["cache"]))
        return out

    # (b) continuous batching over the latent cache, (b') over the dense one
    slots, max_len, chunk, n_req, (lo, hi), steps = sizes["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=steps) for i, n in enumerate(lens)]
    results = {}
    for key, layout in (("engine", "auto"), ("engine_dense", "dense")):
        eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                          slots=slots, prefill_chunk=chunk,
                                          cache_layout=layout, device=dev)
        _sync(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(reqs)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        bodies = dict(ops.FLASH_BODIES)
        decode_bodies = dict(ops.DECODE_BODIES)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        latent = layout == "auto"
        gates(key, launches, bodies, decode_bodies, latent)
        require(sorted(res) == list(range(n_req)) and all(
            len(r["tokens"]) == steps
            and ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size)).all()
            for r in res.values()), f"{tag} {key}: results malformed")
        require(set(eng.prefill_routes.values()) == {"whole_exact"},
                f"{tag} {key}: prefill routes {eng.prefill_routes}")
        ttft = [res[i]["first_token"] - res[i]["arrival"]
                for i in range(n_req)]
        prefill_s = [res[i]["first_token"] - res[i]["admitted"]
                     for i in range(n_req)]
        times = eng.decode_step_times
        out[key] = {
            "launches": launches, "lowrank_rows": lowrank_rows(ops),
            "flash_bodies": bodies, "decode_bodies": decode_bodies,
            "wall_s": wall, "requests": n_req, "prompt_lens": lens.tolist(),
            "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
            "prefill_tokens_per_s": float(sum(lens)) / sum(prefill_s),
            "decode_steps": len(times),
            "decode_step_ms_median": statistics.median(times) * 1e3,
            "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
            "cache": ssm_cache_bytes(M, B, cfg, slots, max_len,
                                     eng._cache_params),
            "peak_bytes": peak}
        results[key] = res
        if latent:
            eng_latent = eng
        label = "(b) engine latent" if latent else "(b') engine dense"
        log(f"{tag} {label} cache:", json.dumps(out[key]))
    same = sum(int((results["engine_dense"][i]["tokens"]
                    == results["engine"][i]["tokens"]).sum())
               for i in range(n_req))
    out["engine_dense"]["tokens_equal_to_latent"] = same / (n_req * steps)
    site = {key: out[key]["cache"]["shared_attn"] for key in
            ("engine", "engine_dense")}
    out["cache"].update({
        "shared_site_latent": site["engine"],
        "shared_site_dense": site["engine_dense"],
        "latent_share": (site["engine"]["per_token"]
                         / site["engine_dense"]["per_token"]),
        "mamba2_state_per_slot": out["engine"]["cache"]["mamba2"],
        "ranks_k_v": [ranks["attn.wk"], ranks["attn.wv"]]})
    log(f"{tag}: cache bytes", json.dumps(out["cache"]))
    require(site["engine"]["layout"] == "latent"
            and site["engine"]["per_token"]
            == (ranks["attn.wk"] + ranks["attn.wv"]) * eb,
            f"{tag}: latent shared site {site['engine']}")
    require(site["engine_dense"]["layout"] == "dense"
            and site["engine_dense"]["per_token"]
            == 2 * cfg.num_kv_heads * cfg.head_dim * eb,
            f"{tag}: dense shared site {site['engine_dense']}")

    # (c) one teacher-forced sequence decoded over the latent and the dense
    # cache, with bf16 and with fp32 activations
    plen, n_dec, max_len = sizes["serve_check"]
    p = eng_latent.params
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen + n_dec),
                                        dtype=np.int32)).to(dev)
    logits = {}
    with torch.inference_mode():
        for act in ("bfloat16", "float32"):
            c = cfg.replace(dtype=act)
            for layout in ("latent", "dense"):
                cache_ = M.init_cache(c, 1, max_len, params=p if layout ==
                                      "latent" else None, device=dev)
                rows_ = [M.prefill(p, c, {"tokens": seq[:, :plen]},
                                   cache_)[0]]
                for i in range(plen, plen + n_dec):
                    pos = torch.tensor([i], dtype=torch.int32, device=dev)
                    rows_.append(M.decode_step(p, c, cache_,
                                               seq[:, i:i + 1], pos)[0])
                logits[f"{layout}_{act}"] = torch.cat(rows_)
                del cache_
    checks = {f"latent_vs_dense_decode_{act}": rel_fro(
        logits[f"latent_{act}"][1:], logits[f"dense_{act}"][1:])
        for act in ("bfloat16", "float32")}
    checks["bf16_vs_fp32_decode"] = {
        layout: rel_fro(logits[f"{layout}_bfloat16"][1:],
                        logits[f"{layout}_float32"][1:])
        for layout in ("latent", "dense")}
    del logits
    out["checks"] = checks
    log(f"{tag} (c) checks (rel Frobenius):", json.dumps(checks))
    # fp32 activations: one function through flash_decode (keys up-projected
    # on chip) and through flash_attention over stored keys, sums in another
    # order: 1e-4, as phases 6 and 12.  bf16 is printed: the dense cache
    # stores bf16 keys, the latent one rank-r bf16 latents
    key = "latent_vs_dense_decode_float32"
    require(math.isfinite(checks[key]) and checks[key] <= 1e-4,
            f"{tag}: {key} {checks[key]:.3e} > 1e-4")

    if on_card:
        out["host_syncs"] = decode_syncs(torch, M, cfg, eng_latent)
        log(f"{tag} (d) host syncs (torch.cuda.set_sync_debug_mode):",
            json.dumps(out["host_syncs"]))
        require(out["host_syncs"]["decode_step_raised"] is None,
                f"{tag}: the decode step synchronized the host: "
                f"{out['host_syncs']['decode_step_raised']}")
        out["profile"] = profile_engine(torch, np, TS, cfg, comp, "auto",
                                        sizes)
        log(f"{tag} (e) device time by kernel:", json.dumps(out["profile"]))
    return out


# ---------------------------------------------------------------------------
# phases 4 and 14: the multimodal archs (whisper-base, phi-3-vision-4.2b)


def frontend_inputs(torch, cfg, n, gen, dev):
    """The stub frontends' inputs of ``n`` sequences, 0.02·N(0, 1) as the
    JAX package's data makes them: ``patches`` (n, P, d) for a vision
    model, ``frames`` (n, Le, d) for whisper, nothing else."""
    if cfg.frontend == "vision":
        return {"patches": 0.02 * torch.randn(
            (n, cfg.num_patches, cfg.d_model), generator=gen, device=dev)}
    if cfg.frontend == "audio":
        return {"frames": 0.02 * torch.randn(
            (n, cfg.encoder_seq_len, cfg.d_model), generator=gen,
            device=dev)}
    return {}


def lm_labels(torch, cfg, t):
    """(tokens, labels) of a (B, L + 1) draw; a vision model's labels span
    its patches too, zeros there, as the JAX package's data makes them."""
    tokens, labels = t[:, :-1], t[:, 1:]
    if cfg.frontend == "vision":
        labels = torch.cat([labels.new_zeros((t.shape[0], cfg.num_patches)),
                            labels], dim=1)
    return tokens, labels


def unit_map_gaps(torch, P, cfg, comp_a, comp_b, report):
    """[(unit, path, plain rel err, rel err on the shifted stream, condition
    number of X′ᵀX′)] of every compressed linear of two compressions of
    one model, in solve order (``report`` from a ``debug_covs`` run: the
    X′ᵀX′ the solve saw).  The shifted-stream error is ||X′ΔW|| /
    ||X′W||."""
    covs = {u["name"]: u.get("covs", {}) for u in report["units"]}
    out = []
    for ua, ub in zip(P.unit_iterator(comp_a, cfg),
                      P.unit_iterator(comp_b, cfg)):
        if ua.params is None:
            continue
        for spec in P.linear_specs(ua.kind, cfg):
            la = P.get_path(ua.params, spec.path)
            lb = P.get_path(ub.params, spec.path)
            ga = (la["v"].cpu().double() @ la["u"].cpu().double())
            gb = (lb["v"].cpu().double() @ lb["u"].cpu().double())
            xpxp = covs[ua.name][spec.tap]["xpxp"].cpu().double()
            lam = torch.linalg.eigvalsh(xpxp)
            cond = float(lam[-1] / lam[0].clamp(min=1e-300))
            out.append((ua.name, spec.path, rel_fro(ga, gb),
                        _shifted_error(torch, ga, gb, xpxp), cond))
    return out


def _worst(gaps, col):
    row = max(gaps, key=lambda g: g[col])
    return row[col], f"{row[0]} {row[1]}"


def phase_refine_off(torch, np, dev="cuda", arch="gemma3-1b",
                     calib_shape=(8, 32)):
    """ROADMAP 3j's check: ``arch``'s smoke config compressed card against
    CPU at ``calib_shape`` tokens with one refine epoch and without, the
    composed maps of both compared plainly and on the shifted stream, with
    each map's X′ᵀX′ condition number: whether the closed-form solves
    agree to 1e-3 where the refined models did not.  Printed, not held."""
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.models import model as M

    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    calib = {"tokens": rng.integers(0, cfg.vocab_size, calib_shape)}
    out = {}
    for refine in (False, True):
        runs = {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            runs[name] = P.compress_model(params, cfg, calib, P.CompressConfig(
                ratio=0.6, rank_multiple=1, microbatch=2, calib_mode="fused",
                refine_epochs=1, refine=refine, debug_covs=True), device=d)
        gaps = unit_map_gaps(torch, P, cfg, runs["card"][0], runs["cpu"][0],
                             runs["cpu"][1])
        by_unit = {}
        for unit, path, plain, shifted, cond in gaps:
            u = by_unit.setdefault(unit, {"plain": 0.0, "shifted": 0.0,
                                          "cond_max": 0.0})
            u["plain"] = max(u["plain"], plain)
            u["shifted"] = max(u["shifted"], shifted)
            u["cond_max"] = max(u["cond_max"], cond)
        key = "refined" if refine else "solves"
        out[key] = {"plain": _worst(gaps, 2), "shifted": _worst(gaps, 3),
                    "by_unit": by_unit,
                    "first_unit_past_1e-3": next(
                        (g[0] for g in gaps if g[2] > 1e-3), None)}
    log(f"3j {arch} ({calib_shape[0]} x {calib_shape[1]} tokens):",
        json.dumps(out))
    return out


def phase_smoke_multimodal_serve(torch, np, cfg, comp, dev):
    """A compressed multimodal smoke model (fp32) served on the card
    (kernels) and on the CPU (plain versions) from the same params, prompts
    and frontend inputs: the engine over the latent and the dense cache (3
    requests on 2 slots, every one ``whole_extras``) and ``Server`` (3
    prompts on 4 slots); tokens equal, teacher-forced logits (prefill, then
    8 decode steps at per-slot positions over the latent cache) within
    1e-4."""
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, 24), dtype=np.int32)
    extras = frontend_inputs(torch, cfg, 3,
                             torch.Generator().manual_seed(2), "cpu")
    extra = TS._prefill_extra_len(cfg)
    lens = (5, 21, 13)
    max_len = 48 + extra
    toks, logits = {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        runs = {}
        for layout in ("auto", "dense"):
            eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                              slots=2, prefill_chunk=8,
                                              cache_layout=layout, device=d)
            res = eng.run([TS.Request(
                rid=i, prompt=prompts[i, :n], steps=8,
                extras={k: v[i:i + 1] for k, v in extras.items()})
                for i, n in enumerate(lens)])
            require(set(eng.prefill_routes.values()) == {"whole_extras"},
                    f"smoke serve {cfg.name}: routes {eng.prefill_routes}")
            runs[f"engine_{layout}"] = [res[i]["tokens"].tolist()
                                        for i in range(3)]
        fixed = TS.Server(cfg, comp, max_len=max_len, batch=4, device=d)
        runs["server"] = fixed.generate(prompts, steps=8,
                                        extras=extras).cpu().tolist()
        toks[name] = runs
        p = fixed.params
        cache = M.init_cache(cfg, 3, max_len, params=p, device=d)
        seq = torch.from_numpy(prompts).to(d)
        ex = {k: v.to(d) for k, v in extras.items()}
        with torch.inference_mode():
            rows = [M.prefill(p, cfg, {"tokens": seq[:, :16], **ex},
                              cache)[0]]
            for i in range(16, 24):
                pos = torch.tensor([i, i - 5, i - 11], dtype=torch.int32,
                                   device=d) + extra
                rows.append(M.decode_step(p, cfg, cache, seq[:, i:i + 1],
                                          pos)[0])
        logits[name] = torch.stack(rows).cpu()
    err = rel_fro(logits["card"], logits["cpu"])
    tag = f"smoke serve {cfg.name}"
    log(f"{tag}: tokens card {json.dumps(toks['card'])} cpu "
        f"{json.dumps(toks['cpu'])}; teacher-forced logits rel err (card vs "
        f"cpu) {err:.3e}")
    require(toks["card"] == toks["cpu"], f"{tag}: tokens differ between the "
            "card and the CPU")
    require(err <= 1e-4, f"{tag}: logits differ by {err:.3e}")
    return {"tokens": toks["card"], "logits_rel_err": err}


def phase_smoke_multimodal(torch, np, dev="cuda", arch="whisper-base",
                           calib_shape=(16, 32), conditioned=True):
    """whisper-base's or phi-3-vision's smoke config (fp32) compressed on
    the card and on the CPU from the same params, ``calib_shape`` uniform
    tokens and frontend inputs (patches at 0.02·N(0, 1), the embeddings'
    scale), with one refine epoch and without: unit names (``enc.*`` then
    ``dec.*``) and ranks equal; the composed maps of the closed-form solves
    within 1e-3 on the shifted stream the solve saw (||X′ΔW|| / ||X′W||:
    a LayerNorm's output has zero feature mean, so the ones vector is in
    every whisper tap's null space and its map along it is fp32 rounding
    on either device; the plain gap and each map's condition number
    printed), the refined maps' gaps printed; the refined models' CE
    within 1e-3; then served on both (``phase_smoke_multimodal_serve``).
    Whisper's stream is made well conditioned as its CPU tests make it
    (``tests/test_torch_whisper.py``; ROADMAP hazard 3k): frames N(0, 1)
    and the embedding table scaled by 50, else the sinusoid positions every
    sequence shares dwarf the 0.02-scale embeddings and frames, and the
    taps' condition numbers reach 1e7-1e10 (the maps of unit 0, on equal
    inputs, 1.2e-3 apart on the card's and the CPU's stream).
    ``conditioned=False`` is that diagnostic: the 0.02 scales, the maps and
    CE printed, not held, nothing served."""
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.models import model as M

    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    scale = 0.02
    if conditioned and cfg.family == "encdec":
        params["embed"]["table"] = params["embed"]["table"] * 50.0
        scale = 1.0
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(3)
    calib = {"tokens": rng.integers(0, cfg.vocab_size, calib_shape),
             **{k: v * (scale / 0.02) for k, v in frontend_inputs(
                 torch, cfg, calib_shape[0], gen, "cpu").items()}}
    t = torch.randint(0, cfg.vocab_size, (8, 33), generator=gen)
    tokens, labels = lm_labels(torch, cfg, t)
    batch = {"tokens": tokens, "labels": labels,
             **{k: v * (scale / 0.02) for k, v in
                frontend_inputs(torch, cfg, 8, gen, "cpu").items()}}
    out = {}
    for refine in (True, False):
        for name, d in (("card", dev), ("cpu", "cpu")):
            comp, rep = P.compress_model(params, cfg, calib, P.CompressConfig(
                ratio=0.6, rank_multiple=1, microbatch=2, calib_mode="fused",
                refine_epochs=1, refine=refine, debug_covs=True), device=d)
            with torch.no_grad():
                ce = float(M.loss_fn(comp, cfg, {
                    k: v.to(d) for k, v in batch.items()})[1]["ce"])
            out[name, refine] = (comp, rep, ce)
    units = {key: [u["name"] for u in out[key][1]["units"]] for key in out}
    ranks = {key: [[lin["rank"] for lin in u["linears"]]
                   for u in out[key][1]["units"]] for key in out}
    held = conditioned or cfg.family != "encdec"
    tag = f"smoke {arch}" + ("" if held else
                             f" (frames and embeddings at {scale}, printed)")
    require(len({json.dumps(u) for u in units.values()}) == 1,
            f"{tag}: units differ {units}")
    require(len({json.dumps(r) for r in ranks.values()}) == 1,
            f"{tag}: ranks differ {ranks}")
    if cfg.family == "encdec":
        names = units["cpu", True]
        n_enc = cfg.num_encoder_layers
        require(names == [f"enc.{i}.enc_attn" for i in range(n_enc)]
                + [f"dec.{i}.dec_attn" for i in range(cfg.num_layers)],
                f"{tag}: unit order {names}")
    gaps = {refine: unit_map_gaps(torch, P, cfg, out["card", refine][0],
                                  out["cpu", refine][0],
                                  out["cpu", refine][1])
            for refine in (False, True)}
    solved = _worst(gaps[False], 3)
    lc, lp = out["card", True][2], out["cpu", True][2]
    res = {"units": units["cpu", True], "ranks": ranks["cpu", True],
           "solves_shifted": solved, "solves_plain": _worst(gaps[False], 2),
           "refined_shifted": _worst(gaps[True], 3),
           "refined_plain": _worst(gaps[True], 2),
           "cond_max": max(g[4] for g in gaps[False]),
           "ce_cuda": lc, "ce_cpu": lp,
           "maps": [list(g) for g in gaps[False]]}
    log(f"{tag} ({calib_shape[0]} x {calib_shape[1]} tokens):",
        json.dumps({k: v for k, v in res.items() if k != "maps"}))
    log(f"{tag} solves (unit, path, plain, shifted, cond):",
        json.dumps(res["maps"]))
    if not held:
        return res
    require(solved[0] <= 1e-3, f"{tag}: composed maps of the solves differ "
            f"by {solved[0]:.3e} on the shifted stream ({solved[1]})")
    require(abs(lc / lp - 1) <= 1e-3, f"{tag} CE {lc} vs {lp}")
    res["serve"] = phase_smoke_multimodal_serve(torch, np, cfg,
                                                out["cpu", True][0], dev)
    return res


def multimodal_cache_bytes(M, B, cfg, slots, max_len, params):
    """Bytes of the engine's decode cache by part, from its own shapes
    (allocated on the ``meta`` device): the self-attention cache a token a
    layer (latent or dense), whisper's cross-attention {"xk", "xv"} a slot
    a layer, and the total."""
    cache = M.init_cache(cfg, slots, max_len, params=params, device="meta")
    layers = sum(st.n for st in B.stage_program(cfg))
    by = {"self": 0, "cross": 0}
    layout = None
    for per_kind in cache:
        for c in per_kind:
            layout = "latent" if "lk" in c else "dense"
            for key, t in c.items():
                part = "cross" if key in ("xk", "xv") else "self"
                by[part] += t.numel() * t.element_size()
    out = {"layout": layout,
           "self_per_token_layer": by["self"] // (slots * max_len * layers),
           "total": by["self"] + by["cross"]}
    if by["cross"]:
        out["cross_per_slot_layer"] = by["cross"] // (slots * layers)
    return out


def phase_multimodal(torch, np, ops, dev="cuda", sizes=SIZES,
                     arch="whisper-base", cfg=None):
    """Phase 14.  (a) whisper-base at its published widths and full depth
    (6 encoder + 6 decoder layers over 1500 frames; d_model 512, 8 heads of
    64, d_ff 2048, vocab 51865; gelu, LayerNorm, tied embeddings), random
    weights: calibration 8 x 448 decoder tokens with 8 x 1500 frames,
    microbatch 4, ratio 0.6, fused, one refine epoch; eval CE; ``Server``
    (dense cache: causal decode in the split body, cross-attention over
    1500 frames non-causal); the engine over the latent cache
    (``flash_decode`` at D 64 with ``rope=False``, every launch in the
    wgmma body) and over the dense one, every request ``whole_extras``.
    (b) phi-3-vision-4.2b at its published widths (d_model 3072, 32 heads
    of 96, d_ff 8192, vocab 32064, 256 patches), depth cut 32 ->
    ``vision_layers``: calibration 8 x (256 patches + 768 tokens), then
    ``Server`` 8 x (256 + 512) and the engine over the latent cache
    (``flash_decode`` at D 96, every launch in the wgmma body) and the
    dense one.  Both: stage seconds, peak memory, TTFT, decode-step ms,
    cache bytes, launches by kernel and body, one teacher-forced sequence
    over both caches (fp32 1e-4), ``decode_step`` under
    ``set_sync_debug_mode("error")``, a profiled engine run."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.launch import serve as TS
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    whisper = arch == "whisper-base"
    tag = "whisper" if whisper else "vision"
    sz = sizes[f"{tag}_shapes"]
    if cfg is None:
        cfg = configs.get_config(arch)
    full = cfg.num_layers
    if not whisper:
        cfg = cfg.replace(num_layers=sizes["vision_layers"])
    program = [(st.kinds, st.n) for st in B.stage_program(cfg)]
    enc = [(st.kinds, st.n) for st in B.encoder_stages(cfg)]
    log(f"{tag}: {arch} widths d_model {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size} act {cfg.act_fn} norm "
        f"{cfg.norm} frontend {cfg.frontend} encoder_seq_len "
        f"{cfg.encoder_seq_len} num_patches {cfg.num_patches}; dtype "
        f"{cfg.dtype} params {cfg.param_dtype}; num_layers {full} -> "
        f"{cfg.num_layers}; encoder {enc}; decoder {program}")
    want = ([(("dec_attn",), cfg.num_layers)] if whisper
            else [(("attn",), cfg.num_layers)])
    require(program == want and (not whisper or enc == [
        (("enc_attn",), cfg.num_encoder_layers)]),
        f"{tag}: stage programs {enc} {program}")
    out = {"layers": cfg.num_layers, "encoder_layers": cfg.num_encoder_layers,
           "program": [[list(k), n] for k, n in enc + program]}

    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    n_cal, l_cal = sz["calib"]
    calib = {"tokens": torch.randint(0, cfg.vocab_size, (n_cal, l_cal),
                                     generator=gen, device=dev),
             **frontend_inputs(torch, cfg, n_cal, gen, dev)}
    evals = []
    n_eval, b_eval, l_eval = sz["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        tokens, labels = lm_labels(torch, cfg, t)
        evals.append({"tokens": tokens, "labels": labels,
                      **frontend_inputs(torch, cfg, b_eval, gen, dev)})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="fused",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"])

    def eval_ce(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[1]["ce"]) for b in evals]

    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    rows = lowrank_rows(ops)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    dense = eval_ce(params)
    compressed = eval_ce(comp)
    stages["eval"] = time.perf_counter() - t0
    ratio = repro_torch.compress_ratio_report(params, comp)
    eval_busy = (eval_busy_share(torch, M, cfg, comp, evals[0]) if on_card
                 else None)
    del params
    ranks = {}
    for u in report["units"]:
        ranks.update({f"{u['name'].split('.')[0]}.{lin['path']}": lin["rank"]
                      for lin in u.get("linears", [])})
    names = [u["name"] for u in report["units"]]
    out["compress"] = {
        "stages": stages, "wall_s": t_compress, "peak_bytes": peak,
        "launches": launches, "lowrank_rows": rows, "flash_bodies": bodies,
        "ratio": ratio, "ranks": ranks, "dense": dense,
        "compressed": compressed, "units": names,
        "tapped_forwards": report["calibration"]["tapped_forwards"],
        "eval_busy": eval_busy,
        "unit_mse": [[u["name"], u.get("pre_refine_mse"),
                      u.get("post_refine_mse")] for u in report["units"]]}
    log(f"{tag}: compress", json.dumps(out["compress"]))
    log(f"{tag}: compress wall {t_compress:.3f} s (solve "
        f"{stages.get('solve', 0.0):.3f} s), peak device memory "
        f"{peak / 2**30:.3f} GiB; eval CE dense {dense} compressed "
        f"{compressed}")
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u.get("pre_refine_mse", 0.0),
                                           u.get("post_refine_mse", 0.0))]
    require(all(math.isfinite(v) for v in vals), f"{tag}: non-finite {vals}")
    for name in ("cov_accum", "lowrank_matmul", "flash_attention",
                 "flash_attention_bwd"):
        require(launches[name] > 0,
                f"{tag}: kernel {name} never launched on compression")
    for name in ("grouped_matmul", "cov_accum_banked", "flash_decode"):
        require(launches[name] == 0, f"{tag}: {name} launched "
                f"{launches[name]} times on compression")
    require(not on_card or bodies.get("wgmma", 0) > 0,
            f"{tag}: flash_attention's wgmma body never taken: {bodies}")
    if whisper:
        want_names = ([f"enc.{i}.enc_attn"
                       for i in range(cfg.num_encoder_layers)]
                      + [f"dec.{i}.dec_attn" for i in range(cfg.num_layers)])
        want_ranks = {"enc.attn.wq": 160, "enc.attn.wo": 160,
                      "enc.ffn.up": 248, "enc.ffn.down": 248,
                      "dec.attn.wk": 160, "dec.xattn.wk": 160,
                      "dec.xattn.wo": 160, "dec.ffn.down": 248}
    else:
        want_names = [f"dec.{i}.attn" for i in range(cfg.num_layers)]
        want_ranks = {"dec.attn.wq": 928, "dec.attn.wk": 928,
                      "dec.attn.wo": 928, "dec.ffn.gate": 1344,
                      "dec.ffn.down": 1344}
    require(names == want_names, f"{tag}: units {names}")
    if cfg.d_model in (512, 3072):     # the published widths
        require(all(ranks.get(k) == v for k, v in want_ranks.items()),
                f"{tag}: ranks {ranks}, want {want_ranks}")
    if on_card:
        torch.cuda.empty_cache()

    def extras_of(n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return frontend_inputs(torch, cfg, n, g, dev)

    def gates(run, launches, bodies, decode_bodies, latent):
        require(launches["lowrank_matmul"] > 0,
                f"{tag} {run}: lowrank_matmul never launched")
        require(launches["flash_attention"] > 0,
                f"{tag} {run}: flash_attention never launched")
        require(launches["grouped_matmul"] == 0,
                f"{tag} {run}: grouped_matmul launched")
        if latent:
            require(launches["flash_decode"] > 0,
                    f"{tag} {run}: flash_decode never launched")
            require(not on_card or (decode_bodies.get("wgmma", 0)
                                    == launches["flash_decode"]),
                    f"{tag} {run}: flash_decode outside its wgmma body: "
                    f"{decode_bodies}")
        else:
            require(launches["flash_decode"] == 0,
                    f"{tag} {run}: flash_decode launched over a dense cache")
        # a dense cache's decode, and whisper's cross-attention at decode
        # under either layout, take the split body (one-row queries)
        require(not on_card or (latent and not whisper)
                or bodies.get("split", 0) > 0,
                f"{tag} {run}: no decode in the split body: {bodies}")

    # (a) fixed batch (its cache built without params: dense)
    rng = np.random.default_rng(41)
    b, plen, steps, max_len = sz["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    extras = extras_of(b, 5)
    srv = TS.Server(cfg, comp, max_len=max_len, batch=b, device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    first = srv.generate(prompts, steps=1, extras=extras).cpu()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, steps=steps, extras=extras).cpu()
    t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gates("Server", launches, bodies, dict(ops.DECODE_BODIES), False)
    require(tuple(toks.shape) == (b, steps) and torch.equal(toks[:, :1],
                                                            first)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{tag}: Server tokens malformed: {tuple(toks.shape)}")
    decode_s = t_all - t_prefill
    out["server"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "flash_bodies": bodies, "ttft_s": t_prefill,
        "prefill_tokens_per_s": b * plen / t_prefill,
        "decode_tokens_per_s": b * (steps - 1) / decode_s,
        "decode_step_ms": decode_s / (steps - 1) * 1e3,
        "generate_s": t_all, "peak_bytes": peak,
        "cache": multimodal_cache_bytes(M, B, cfg, b, max_len, None),
        "tokens_head": toks[:, :8].tolist()}
    log(f"{tag} (a) Server:", json.dumps(out["server"]))
    del srv

    # (b) continuous batching over the latent cache, (b') over the dense one
    slots, max_len, n_req, (lo, hi), steps = sz["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    req_extras = extras_of(n_req, 6)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=steps,
                       extras={k: v[i:i + 1] for k, v in req_extras.items()})
            for i, n in enumerate(lens)]
    results = {}
    for key, layout in (("engine", "auto"), ("engine_dense", "dense")):
        eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                          slots=slots, prefill_chunk=256,
                                          cache_layout=layout, device=dev)
        _sync(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(reqs)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        bodies = dict(ops.FLASH_BODIES)
        decode_bodies = dict(ops.DECODE_BODIES)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        latent = layout == "auto"
        gates(key, launches, bodies, decode_bodies, latent)
        require(sorted(res) == list(range(n_req)) and all(
            len(r["tokens"]) == steps
            and ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size)).all()
            for r in res.values()), f"{tag} {key}: results malformed")
        require(set(eng.prefill_routes.values()) == {"whole_extras"},
                f"{tag} {key}: prefill routes {eng.prefill_routes}")
        ttft = [res[i]["first_token"] - res[i]["arrival"]
                for i in range(n_req)]
        prefill_s = [res[i]["first_token"] - res[i]["admitted"]
                     for i in range(n_req)]
        times = eng.decode_step_times
        out[key] = {
            "launches": launches, "lowrank_rows": lowrank_rows(ops),
            "flash_bodies": bodies, "decode_bodies": decode_bodies,
            "wall_s": wall, "requests": n_req, "prompt_lens": lens.tolist(),
            "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
            "prefill_tokens_per_s": float(sum(lens)) / sum(prefill_s),
            "decode_steps": len(times),
            "decode_step_ms_median": statistics.median(times) * 1e3,
            "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
            "cache": multimodal_cache_bytes(M, B, cfg, slots, max_len,
                                            eng._cache_params),
            "peak_bytes": peak}
        results[key] = res
        if latent:
            eng_latent = eng
        label = "(b) engine latent" if latent else "(b') engine dense"
        log(f"{tag} {label}:", json.dumps(out[key]))
    same = sum(int((results["engine_dense"][i]["tokens"]
                    == results["engine"][i]["tokens"]).sum())
               for i in range(n_req))
    out["engine_dense"]["tokens_equal_to_latent"] = same / (n_req * steps)
    eb = 2 if cfg.dtype == "bfloat16" else 4
    lat, den = out["engine"]["cache"], out["engine_dense"]["cache"]
    out["cache"] = {"latent": lat, "dense": den,
                    "latent_share": (lat["self_per_token_layer"]
                                     / den["self_per_token_layer"]),
                    "ranks_k_v": [ranks["dec.attn.wk"],
                                  ranks["dec.attn.wv"]]}
    log(f"{tag}: cache bytes", json.dumps(out["cache"]))
    require(lat["layout"] == "latent" and lat["self_per_token_layer"]
            == (ranks["dec.attn.wk"] + ranks["dec.attn.wv"]) * eb,
            f"{tag}: latent cache {lat}")
    require(den["layout"] == "dense" and den["self_per_token_layer"]
            == 2 * cfg.num_kv_heads * cfg.head_dim * eb,
            f"{tag}: dense cache {den}")
    if whisper:
        want_x = 2 * cfg.encoder_seq_len * cfg.num_kv_heads * cfg.head_dim * eb
        require(lat["cross_per_slot_layer"] == den["cross_per_slot_layer"]
                == want_x, f"{tag}: cross-attention cache a slot a layer "
                f"{lat.get('cross_per_slot_layer')}, want {want_x}")

    # (c) one teacher-forced sequence decoded over the latent and the dense
    # cache, with bf16 and with fp32 activations
    plen, n_dec, max_len = sz["serve_check"]
    p = eng_latent.params
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen + n_dec),
                                        dtype=np.int32)).to(dev)
    ex = extras_of(1, 7)
    extra = TS._prefill_extra_len(cfg)
    logits = {}
    with torch.inference_mode():
        for act in ("bfloat16", "float32"):
            c = cfg.replace(dtype=act)
            for layout in ("latent", "dense"):
                cache_ = M.init_cache(c, 1, max_len, params=p if layout ==
                                      "latent" else None, device=dev)
                rows_ = [M.prefill(p, c, {"tokens": seq[:, :plen], **ex},
                                   cache_)[0]]
                for i in range(plen, plen + n_dec):
                    pos = torch.tensor([i + extra], dtype=torch.int32,
                                       device=dev)
                    rows_.append(M.decode_step(p, c, cache_,
                                               seq[:, i:i + 1], pos)[0])
                logits[f"{layout}_{act}"] = torch.cat(rows_)
                del cache_
    checks = {f"latent_vs_dense_decode_{act}": rel_fro(
        logits[f"latent_{act}"][1:], logits[f"dense_{act}"][1:])
        for act in ("bfloat16", "float32")}
    checks["bf16_vs_fp32_decode"] = {
        layout: rel_fro(logits[f"{layout}_bfloat16"][1:],
                        logits[f"{layout}_float32"][1:])
        for layout in ("latent", "dense")}
    del logits
    out["checks"] = checks
    log(f"{tag} (c) checks (rel Frobenius):", json.dumps(checks))
    # fp32 activations: one function through flash_decode (keys up-projected
    # on chip) and through flash_attention over stored keys, sums in another
    # order: 1e-4, as phases 6, 12 and 13
    key = "latent_vs_dense_decode_float32"
    require(math.isfinite(checks[key]) and checks[key] <= 1e-4,
            f"{tag}: {key} {checks[key]:.3e} > 1e-4")

    if on_card:
        out["host_syncs"] = decode_syncs(torch, M, cfg, eng_latent)
        log(f"{tag} (d) host syncs (torch.cuda.set_sync_debug_mode):",
            json.dumps(out["host_syncs"]))
        require(out["host_syncs"]["decode_step_raised"] is None,
                f"{tag}: the decode step synchronized the host: "
                f"{out['host_syncs']['decode_step_raised']}")
        prof_extras = extras_of(sizes["serve_engine"][0], 8)
        out["profile"] = profile_engine(
            torch, np, TS, cfg, comp, "auto", sizes,
            extras=lambda i: {k: v[i:i + 1] for k, v in prof_extras.items()},
            max_len=sz["serve_engine"][1])
        log(f"{tag} (e) device time by kernel:", json.dumps(out["profile"]))
    return out


# ---------------------------------------------------------------------------
# phase 15: the trainer


def _np_batch(np, cfg, rng, b, seq):
    """A numpy LM batch of ``b`` x ``seq`` uniform tokens with the stub
    frontends' inputs as the JAX package's data shapes them (0.02·N(0, 1)
    patches with labels zero under them, or frames)."""
    t = rng.integers(0, cfg.vocab_size, (b, seq + 1), dtype=np.int32)
    out = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if cfg.frontend == "vision":
        out["patches"] = (0.02 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
        out["labels"] = np.concatenate(
            [np.zeros((b, cfg.num_patches), np.int32), out["labels"]], 1)
    if cfg.frontend == "audio":
        out["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return out


def _leaf_gap(torch, a, b):
    """Relative Frobenius gap of ``a`` to ``b`` (absolute where b is 0)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _named_leaves(tree):
    from repro_torch.checkpoint.manager import _flatten_with_paths
    return _flatten_with_paths(tree)


def phase_train_smoke(torch, np, ops, dev="cuda", arch="llama-7b",
                      dispatch=None):
    """(a) Three train steps of a smoke config (fp32) on the card and on
    the CPU from the same params and numpy batches, under the trainer's
    schedule for 3 steps (step 1 moves only the moments): the losses and
    every param leaf after step 3, gated by the caller."""
    from repro_torch import configs
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    if dispatch == "dropfree":
        cfg = _dropfree(cfg)
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batches = [_np_batch(np, cfg, rng, 2, 32) for _ in range(3)]
    step = S.make_train_step(cfg, lr_schedule=adamw.cosine_schedule(
        1.0, 3, warmup_steps=1))
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        state = S.train_state_for(tree_map(lambda t: t.to(d), params))
        ops.reset_launches()
        losses = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(d)
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs[name] = (losses, state, dict(ops.LAUNCHES))
    (lc, sc, launches), (lp, sp, _) = runs["card"], runs["cpu"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    gaps = {n: _leaf_gap(torch, a, b) for (n, a), (_, b) in zip(
        _named_leaves(sc.params), _named_leaves(sp.params))}
    worst = max(gaps, key=gaps.get)
    tag = arch + ("" if dispatch is None else f" ({dispatch})")
    log(f"train (a) {tag}: losses card {lc} cpu {lp}, rel gap "
        f"{loss_gap:.3e}; params after step 3: worst rel gap "
        f"{gaps[worst]:.3e} ({worst}); card launches", json.dumps(
            {k: v for k, v in launches.items() if v}))
    return {"arch": arch, "dispatch": dispatch, "losses_card": lc,
            "losses_cpu": lp, "loss_rel_gap": loss_gap,
            "param_worst": [worst, gaps[worst]], "launches": launches,
            "finite": all(math.isfinite(v) for v in lc + lp)}


def _model_flops(cfg, b, l):
    """Model flops of one train step without remat: 3x the forward's
    (every linear, the tied head, causal attention's two products over the
    causal triangle)."""
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    lin = d * hd + 2 * d * kvd + hd * d + 3 * d * cfg.d_ff
    fwd = 2 * b * l * (cfg.num_layers * lin + d * cfg.vocab_size)
    fwd += cfg.num_layers * 4 * b * hd * l * (l + 1) // 2
    return 3 * fwd


class _StepClock:
    """Each train step's end on the device timeline (CUDA events recorded
    after the step's launches: no sync), or on the host clock on the CPU;
    ``ms()`` gives each step's time from the previous step's end."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, torch.device(dev).type == "cuda"
        self.marks = [self._mark()]
        self.host = []                  # each tick's host clock

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def tick(self):
        self.marks.append(self._mark())
        self.host.append(time.perf_counter())

    def ms(self):
        if self.cuda:
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _capture_train(fn):
    """Run ``fn()`` with the trainer's prints captured: (result, lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def train_step_split(torch, step, state, batch):
    """One train step's device time under ``torch.profiler``: the forward
    (the ``train_step/forward`` range, ``M.loss_fn`` alone), the attention
    backward (``_FlashAttentionBackward``: the backward kernel's launches),
    the rest of the step's kernels (the backward, remat's recomputed
    forwards included), AdamW, ``flash_wgmma`` (every launch: forward and
    recompute) and the backward kernel's own launches (``fab_delta``,
    ``bwd_kv_*``, ``bwd_q_*``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()

    def dev_ms(evt):
        return getattr(evt, "device_time_total",
                       getattr(evt, "cuda_time_total", 0.0)) / 1e3

    # one pass over the events (each pass takes seconds at ~10k launches)
    avgs = prof.key_averages()
    by_key = {e.key: dev_ms(e) for e in avgs
              if e.device_type != DeviceType.CUDA}
    # the device side of each record_function range shows as an event of
    # its own name: kernels only
    kernels = {}
    for e in avgs:
        if e.device_type == DeviceType.CUDA and e.key not in by_key:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    total = sum(kernels.values())
    fwd = by_key.get("train_step/forward", 0.0)
    adam = by_key.get("train_step/adamw", 0.0)
    attn_bwd = by_key.get(
        "autograd::engine::evaluate_function: _FlashAttentionBackward", 0.0)
    return {
        "device_total_ms": total, "forward_ms": fwd,
        "flash_wgmma_ms": sum(v for k, v in kernels.items()
                              if "flash_wgmma" in k),
        "flash_attention_bwd_ms": sum(
            v for k, v in kernels.items()
            if any(n in k for n in ("fab_delta", "bwd_kv_", "bwd_q_"))),
        "attention_backward_ms": attn_bwd,
        "other_backward_ms": total - fwd - adam - attn_bwd,
        "adamw_ms": adam, "top_kernels_ms": top_kernels(kernels, 12)}


def phase_train_run(torch, np, ops, dev="cuda", sizes=SIZES, cfg=None):
    """(b) qwen3-0.6b at its published widths and depth through
    ``launch.train.train``; returns (record, cfg, trained params)."""
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as T

    cfg = cfg or configs.get_config("qwen3-0.6b")
    b, l = sizes["train_shape"]
    steps, every = sizes["train_steps"], sizes["train_ckpt_every"]
    on_card = torch.device(dev).type == "cuda"
    log(f"train (b): {cfg.name} {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"{cfg.tie_embeddings}, dtype {cfg.dtype} params {cfg.param_dtype}, "
        f"remat {cfg.remat}; B {b} x L {l}, {steps} steps, lr 3e-4, "
        f"checkpoint every {every}")
    clock, first = _StepClock(torch, dev), []
    make, saves = S.make_train_step, {"save_s": [], "wait_s": 0.0}

    class Timed(CheckpointManager):
        # host seconds in the trainer's save calls (the copy to the host)
        # and waits (the writes of the thread, fsync included)
        def save(self, *a, **kw):
            t = time.perf_counter()
            super().save(*a, **kw)
            saves["save_s"].append(time.perf_counter() - t)

        def wait(self):
            t = time.perf_counter()
            super().wait()
            saves["wait_s"] += time.perf_counter() - t

    def timed(*args, **kw):
        fn = make(*args, **kw)

        def step(state, batch):
            out = fn(state, batch)
            clock.tick()
            if not first:
                first.append(out[1]["loss"])
            return out

        return step

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    saved_cls, S.make_train_step, T.CheckpointManager = (
        T.CheckpointManager, timed, Timed)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            clock.marks = [clock._mark()]
            (state, info), lines = _capture_train(lambda: T.train(
                cfg, steps=steps, batch=b, seq_len=l, ckpt_dir=d,
                ckpt_every=every, lr=3e-4, log_every=10, device=dev))
            wall = time.perf_counter() - t0
            saved = CheckpointManager(d, async_save=False).all_steps()
            ckpt_bytes = _dir_bytes(d)
    finally:
        S.make_train_step, T.CheckpointManager = make, saved_cls
    step_ms = clock.ms()
    launches, bodies = dict(ops.LAUNCHES), dict(ops.FLASH_BODIES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for line in lines:
        log("train (b):", line)
    losses = info["losses"]
    median = statistics.median(step_ms[1:])
    flops = _model_flops(cfg, b, l)
    rec = {"steps": steps, "shape": [b, l], "wall_s": wall,
           "loss_step1": float(first[0]), "loss_first_log": losses[0],
           "loss_last_log": losses[-1], "losses_logged": losses,
           "loss_fall": losses[0] - losses[-1], "step_ms": step_ms,
           "median_step_ms": median, "tokens_per_s": b * l / median * 1e3,
           "model_flops": flops,
           "model_flops_bound_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3,
           "model_flops_share": flops / PEAK_FLOPS["bfloat16"]
           / (median / 1e3),
           "peak_bytes": peak, "checkpoints": saved,
           "checkpoint_bytes": ckpt_bytes, "launches": launches,
           "flash_bodies": bodies,
           # host seconds of train(): to the end of step 1's launches (init
           # included), steps 2..N, after the last step (the final save and
           # its wait); the save calls and the waits among them
           "times_s": {"to_step_1": clock.host[0] - t0,
                       "steps_2_to_n": clock.host[-1] - clock.host[0],
                       "after_last_step": t0 + wall - clock.host[-1],
                       "save_calls": saves["save_s"],
                       "waits": saves["wait_s"]}}
    log(f"train (b): loss step 1 {rec['loss_step1']:.4f}, first log "
        f"{losses[0]:.4f}, last log {losses[-1]:.4f} (fall "
        f"{rec['loss_fall']:.4f}); median step {median:.3f} ms (first "
        f"{step_ms[0]:.1f} ms), {rec['tokens_per_s']:.0f} tokens/s; model "
        f"flops {flops:.4e} a step, bound {rec['model_flops_bound_ms']:.3f} "
        f"ms, share {rec['model_flops_share']:.4f}; peak "
        f"{peak / 2**30:.3f} GiB; wall {wall:.3f} s; checkpoints {saved} "
        f"({ckpt_bytes / 2**30:.3f} GiB on disk)")
    log("train (b): launches", json.dumps(launches), "flash_attention by "
        "body", json.dumps(bodies), "host seconds", json.dumps(rec["times_s"]))
    require(all(math.isfinite(v) for v in losses + [rec["loss_step1"]]),
            f"non-finite training loss: {losses}")
    require(rec["loss_fall"] >= 0.5, f"the loss fell {rec['loss_fall']:.4f} "
            "nats from the first log to the last, under 0.5")
    require(saved and saved[-1] == steps, f"checkpoints {saved}")
    require(launches["flash_attention"] > 0,
            "flash_attention never launched on the training path")

    # one more step on the trained state: its launches and host syncs,
    # then one profiled
    batch = next(make_batch_iterator(cfg, b, l, seed=1, device=dev))
    step = S.make_train_step(cfg)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    ops.reset_launches()
    t = time.perf_counter()
    try:
        step(state, batch)
        rec["step_host_syncs"] = "none"
    except RuntimeError as e:
        rec["step_host_syncs"] = str(e)[:300]
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    _sync(torch, dev)
    require(rec["step_host_syncs"] == "none", "the train step synchronized "
            f"the host: {rec['step_host_syncs']}")
    # one backward kernel launch a layer (remat recomputes each layer's
    # forward, with its LSE, inside the backward)
    require(ops.LAUNCHES["flash_attention_bwd"] == cfg.num_layers,
            "flash_attention_bwd launched "
            f"{ops.LAUNCHES['flash_attention_bwd']} times in one train step, "
            f"want {cfg.num_layers}")
    rec["times_s"]["sync_check_step"] = time.perf_counter() - t
    rec["launches_per_step"] = dict(ops.LAUNCHES)
    rec["flash_bodies_per_step"] = dict(ops.FLASH_BODIES)
    if on_card:
        t = time.perf_counter()
        rec["split"] = train_step_split(torch, step, state, batch)
        rec["times_s"]["profiled_step"] = time.perf_counter() - t
        # the device's busy share: a profiled step's device time over the
        # training run's median step (one unprofiled step's wall varied
        # 480-686 ms between runs); the model-flops share of that time
        dev_ms = rec["split"]["device_total_ms"]
        rec["busy_share"] = dev_ms / median
        rec["model_flops_share_of_device_ms"] = (
            rec["model_flops_bound_ms"] / dev_ms)
        log("train (b): one step's launches", json.dumps(
            rec["launches_per_step"]), "flash_attention by body",
            json.dumps(rec["flash_bodies_per_step"]), "host syncs:",
            rec["step_host_syncs"], f"busy share {rec['busy_share']:.4f}, "
            "model-flops share of the device time "
            f"{rec['model_flops_share_of_device_ms']:.4f}; the sync-check "
            f"step {rec['times_s']['sync_check_step']:.3f} s, the profiled "
            f"step {rec['times_s']['profiled_step']:.3f} s")
        log("train (b): step split (ms)", json.dumps(rec["split"]))
    return rec, cfg, state.params


def phase_train_restart(torch, np, ops, dev="cuda", sizes=SIZES, cfg=None):
    """(c) 20 steps with a checkpoint at 10 against the same run stopped
    there and resumed: the restored state bit for bit the saved one, every
    batch the uninterrupted run's, the resumed params' largest gap; a
    determinism probe (one state's grads twice) names the leaves whose
    backward is not bitwise."""
    import hashlib as hl
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_map

    cfg = (cfg or configs.get_config("qwen3-0.6b")).replace(
        num_layers=sizes["train_restart_layers"])
    b, l = sizes["train_shape"]
    steps, every = sizes["train_restart"]
    snaps, restored, seen = {}, {}, {"a": [], "b": []}
    run = ["a"]

    def clone(t):
        return t.detach().clone() if torch.is_tensor(t) else t

    class Recording(CheckpointManager):
        def save(self, step, state, **kw):
            if run[0] == "a" and step == every:
                snaps[step] = tree_map(clone, state)
            super().save(step, state, **kw)

        def restore(self, step, like, **kw):
            s, tree = super().restore(step, like, **kw)
            restored[s] = tree
            return s, tree

    def recording_batches(*args, **kw):
        for i, bt in enumerate(make_batch_iterator(*args, **kw)):
            h = hl.sha256()
            for k in sorted(bt):
                h.update(bt[k].cpu().numpy().tobytes())
            seen[run[0]].append((kw.get("start_step", 0) + i,
                                 h.hexdigest()[:16]))
            yield bt

    saved_cls, saved_iter = T.CheckpointManager, T.make_batch_iterator
    T.CheckpointManager, T.make_batch_iterator = Recording, recording_batches
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            (state_a, info_a), lines_a = _capture_train(lambda: T.train(
                cfg, steps=steps, batch=b, seq_len=l, ckpt_dir=d,
                ckpt_every=every, log_every=1, device=dev))
            t_a = time.perf_counter() - t0
            shutil.rmtree(pathlib.Path(d) / f"step_{steps:09d}")
            run[0] = "b"
            (state_b, info_b), lines_b = _capture_train(lambda: T.train(
                cfg, steps=steps, batch=b, seq_len=l, ckpt_dir=d,
                ckpt_every=every, log_every=1, device=dev))
    finally:
        T.CheckpointManager, T.make_batch_iterator = saved_cls, saved_iter
    wall = time.perf_counter() - t0
    for line in lines_b[:1]:
        log("train (c):", line)
    pairs = list(zip(_named_leaves(restored[every]),
                     _named_leaves(snaps[every])))
    restore_bitwise = all(
        (torch.equal(x, y.to(x.device)) if torch.is_tensor(y)
         else int(x) == int(y)) for (_, x), (_, y) in pairs)
    batches_equal = seen["b"] == seen["a"][every:]
    gaps = {}
    for part in ("params", "m", "v"):
        ta = state_a.params if part == "params" else getattr(state_a.opt,
                                                               part)
        tb = state_b.params if part == "params" else getattr(state_b.opt,
                                                               part)
        for (n, x), (_, y) in zip(_named_leaves(tb), _named_leaves(ta)):
            gaps[f"{part}/{n}"] = float((x.float() - y.float()).abs().max())
    worst = max(gaps, key=gaps.get)
    bitwise = all(v == 0.0 for v in gaps.values())
    loss_gap = max(abs(x - y) for x, y in zip(info_b["losses"],
                                              info_a["losses"][every:]))
    # determinism probe: the same state's loss and grads twice
    batch = next(make_batch_iterator(cfg, b, l, seed=5, device=dev))
    g1 = S.loss_and_grads(cfg, state_b.params, batch)
    g2 = S.loss_and_grads(cfg, state_b.params, batch)
    unequal = [n for (n, x), (_, y) in zip(_named_leaves(g1[2]),
                                           _named_leaves(g2[2]))
               if not torch.equal(x, y)]
    rec = {"layers": cfg.num_layers, "steps": steps, "ckpt_every": every,
           "wall_s": wall, "run_a_s": t_a, "restore_bitwise": restore_bitwise,
           "batches_equal": batches_equal, "batches_checked": len(seen["b"]),
           "resumed_bitwise": bitwise, "largest_gap": [worst, gaps[worst]],
           "loss_gap_steps_11_20": loss_gap,
           "probe_loss_equal": bool(torch.equal(g1[0], g2[0])),
           "probe_unequal_grads": unequal}
    log(f"train (c): {cfg.num_layers} layers, {steps} steps, checkpoint at "
        f"{every}: restored state bit for bit the saved one "
        f"{restore_bitwise}; the resumed run's {len(seen['b'])} batches "
        f"equal {batches_equal}; resumed state bit for bit {bitwise}, "
        f"largest gap {gaps[worst]:.3e} ({worst}), losses' largest gap "
        f"{loss_gap:.3e}; probe: loss equal {rec['probe_loss_equal']}, "
        f"grads unequal at {unequal}; wall {wall:.3f} s (run a "
        f"{t_a:.3f} s)")
    require(restore_bitwise, "the restored train state differs from the "
            "saved one")
    require(batches_equal, f"resumed batches differ: {seen}")
    require(info_b["step"] == steps and len(info_b["losses"]) == steps
            - every, f"resumed run: {info_b}")
    return rec


def phase_train_compress(torch, np, ops, dev="cuda", sizes=SIZES, cfg=None,
                         params=None):
    """(d) The trained model compressed by AA-SVD (ratio 0.8, fused
    calibration, one refine epoch) and by naive SVD (agnostic objective,
    no refinement) on the port's calibration set, held-out ppl of base,
    AA-SVD and naive, then the AA-SVD model served by ``Server``."""
    import itertools

    import repro_torch
    from repro_torch.data import calibration_set, make_batch_iterator
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as M

    n_cal, l_cal = sizes["train_calib"]
    mb = sizes["train_microbatch"]
    n_ev, b_ev, l_ev = sizes["train_evals"]
    on_card = torch.device(dev).type == "cuda"
    calib = calibration_set(cfg, n_cal, l_cal, device=dev)
    evals = list(itertools.islice(
        make_batch_iterator(cfg, b_ev, l_ev, seed=99, device=dev), n_ev))

    eval_s = []

    def ppl(p):
        t = time.perf_counter()
        with torch.no_grad():
            losses = [float(M.loss_fn(p, cfg, bt)[0]) for bt in evals]
        eval_s.append(time.perf_counter() - t)
        return math.exp(sum(losses) / len(losses))

    rec = {"calib": [n_cal, l_cal],
           "tokens_per_d_model": n_cal * l_cal / cfg.d_model,
           "microbatch": mb, "ppl_base": ppl(params)}
    recipes = {
        "aa_svd": repro_torch.CompressConfig(
            ratio=0.8, calib_mode="fused", refine_epochs=1, microbatch=mb),
        "naive": repro_torch.CompressConfig(
            ratio=0.8, objective="agnostic", refine=False,
            calib_mode="fused", microbatch=mb)}
    comp = None
    for name, ccfg in recipes.items():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        stages = {}
        t0 = time.perf_counter()
        out, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                                 device=dev,
                                                 stage_times=stages)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        mse = [(u["pre_refine_mse"], u.get("post_refine_mse",
                                            u["pre_refine_mse"]))
               for u in report["units"]]
        rec[name] = {"wall_s": wall, "stages": stages, "launches": launches,
                     "flash_bodies": dict(ops.FLASH_BODIES),
                     "lowrank_rows": lowrank_rows(ops),
                     "peak_bytes": (torch.cuda.max_memory_allocated()
                                    if on_card else 0),
                     "ppl": ppl(out),
                     "ranks": [lin["rank"] for lin in
                               report["units"][0]["linears"]],
                     "unit_mse_pre_post": mse,
                     "units_refine_raised": sum(b > a for a, b in mse)}
        log(f"train (d) {name}: wall {wall:.3f} s, stages",
            json.dumps(stages), "launches", json.dumps(launches),
            f"ppl {rec[name]['ppl']:.4f}, unit 0 ranks {rec[name]['ranks']};"
            f" refinement raised the unit MSE in "
            f"{rec[name]['units_refine_raised']} of {len(mse)} units; units"
            f" 0, 1, last (pre, post): {mse[0]}, {mse[1]}, {mse[-1]}")
        require(launches["cov_accum"] > 0 or name == "naive",
                f"cov_accum never launched compressing ({name})")
        if name == "aa_svd":
            comp = out
            require(launches["lowrank_matmul"] > 0
                    and launches["flash_attention_bwd"] > 0,
                    f"compressing ({name}) launched {launches}")
        del out
    rec["ordering_aa_lt_naive"] = rec["aa_svd"]["ppl"] < rec["naive"]["ppl"]
    rec["aa_within_1_6_base"] = rec["aa_svd"]["ppl"] < 1.6 * rec["ppl_base"]
    log(f"train (d): held-out ppl base {rec['ppl_base']:.4f}, AA-SVD "
        f"{rec['aa_svd']['ppl']:.4f}, naive {rec['naive']['ppl']:.4f}; "
        f"AA-SVD < naive {rec['ordering_aa_lt_naive']}, AA-SVD < 1.6 x base "
        f"{rec['aa_within_1_6_base']} (printed, not gated)")
    require(all(math.isfinite(v) for v in (
        rec["ppl_base"], rec["aa_svd"]["ppl"], rec["naive"]["ppl"])),
        "non-finite ppl")

    t_serve = time.perf_counter()
    n_req, plen, n_steps = sizes["train_serve"]
    prompts = next(make_batch_iterator(cfg, n_req, plen, seed=7,
                                       device=dev))["tokens"]
    srv = Server(cfg, comp, max_len=plen + n_steps, batch=n_req, device=dev)
    with torch.inference_mode():
        srv.generate(prompts, steps=2)     # warm-up
        _sync(torch, dev)
        t0 = time.perf_counter()
        srv.generate(prompts, steps=1)
        _sync(torch, dev)
        t_prefill = time.perf_counter() - t0
        ops.reset_launches()
        t0 = time.perf_counter()
        toks = srv.generate(prompts, steps=n_steps)
        _sync(torch, dev)
        t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    rec["serve"] = {"batch": n_req, "prompt": plen, "steps": n_steps,
                    "prefill_s": t_prefill, "generate_s": t_all,
                    "decode_ms": (t_all - t_prefill) / (n_steps - 1) * 1e3,
                    "launches": launches,
                    "flash_bodies": dict(ops.FLASH_BODIES),
                    "lowrank_rows": lowrank_rows(ops),
                    "tokens_in_vocab": in_vocab,
                    "shape": list(toks.shape)}
    log(f"train (d) serve: Server {n_req} x {plen} prompts, {n_steps} steps:"
        f" prefill {t_prefill * 1e3:.3f} ms, decode "
        f"{rec['serve']['decode_ms']:.3f} ms a step, tokens in vocab "
        f"{in_vocab}; launches", json.dumps(launches), "flash_attention by "
        "body", json.dumps(rec["serve"]["flash_bodies"]))
    rec["times_s"] = {"evals": eval_s, "compress": [
        rec[k]["wall_s"] for k in recipes],
        "serve": time.perf_counter() - t_serve}
    log("train (d): host seconds (held-out evals base, AA-SVD, naive; "
        "compress AA-SVD, naive; serve)", json.dumps(rec["times_s"]))
    require(in_vocab and tuple(toks.shape) == (n_req, n_steps),
            f"served tokens {tuple(toks.shape)} in vocab {in_vocab}")
    require(launches["lowrank_matmul"] > 0 and
            launches["flash_attention"] > 0,
            f"serving the trained model launched {launches}")
    return rec


def phase_train_attention(torch, np, ops, ref, dev="cuda"):
    """(e) ``flash_attention`` at qwen3-0.6b's training shape (B 8, 16
    query heads on 8, L 512, D 128, causal) through the case table's row
    (bf16 timed; fp32 checked), then its backward: the kernel's row (both
    dtypes, bf16 timed with the L2 cold), the backward through autograd
    (the forward writing its LSE, then the kernel) against the plain
    backward's time (the fp32 einsum scan recomputed and differentiated),
    SDPA's ``is_causal`` with ``enable_gqa``, forward and forward +
    backward, and a backward-only bound."""
    case = ("qwen3_train", 8, 16, 8, 512, 512, 128, True, 0, 0.0, 0)
    row32 = check_flash_attention(torch, np, ops, ref, case, torch.float32,
                                  False, dev)
    row = check_flash_attention(torch, np, ops, ref, case, torch.bfloat16,
                                True, dev)
    bwd32 = check_flash_backward(torch, np, ops, ref, case, torch.float32,
                                 False, dev)
    bwd = check_flash_backward(torch, np, ops, ref, case, torch.bfloat16,
                               True, dev)
    plain_bwd = PLAIN_BWD["fn"] or ref.flash_attention_bwd_ref
    q, k, v, _, kw = _flash_inputs(torch, np, case, torch.bfloat16, dev)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, **kw)
    gen = torch.Generator(device=dev).manual_seed(9)
    dout = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
    grads = torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)
    row["backward_ms"] = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), dout, retain_graph=True), warmup=1, reps=5)
    row["plain_backward_ms"] = time_ms(lambda: plain_bwd(q, k, v, dout,
                                                         **kw),
                                       warmup=1, reps=5)
    row["backward_kernel_ms"] = bwd["ms"]
    row["backward_kernel_device_ms"] = bwd["device_ms"]
    row["backward_kernels_device_ms"] = bwd["kernels_device_ms"]
    row["backward_rel_fro_err"] = bwd["rel_fro_err"]
    row["backward_fp32_rel_fro_err"] = bwd32["rel_fro_err"]
    row["backward_bound_ms"], row["backward_bound_by"] = (
        bwd["bound_ms"], bwd["bound_by"])
    # SDPA's backward alone (is_causal, enable_gqa) on the same inputs
    row["library_backward_ms"] = bwd["library_ms"]
    row["library_backward_kernels_device_ms"] = bwd["library_device_ms"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dt)

    lib = sdpa_fwd_bwd()
    row["library_causal_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, warmup=1,
                                               reps=5)
    row["library_causal_fwd_bwd_device_ms"] = device_ms(sdpa_fwd_bwd)
    # the kernel's grads (through autograd) beside SDPA's (bf16 both)
    row["backward_rel_err_vs_sdpa"] = [
        rel_fro(g, s_.transpose(1, 2)) for g, s_ in zip(grads, lib)]
    b, h, kv, lq, lk, d = 8, 16, 8, 512, 512, 128
    fwd_flops = 4 * b * h * d * lq * (lq + 1) // 2
    eb = 2
    # backward: S and P recomputed, dV, dP, dQ, dK (2.5x the forward's
    # products); reads q, k, v, o, dO, writes dq, dk, dv
    bwd_bytes = (3 * b * lq * h * d + 2 * 2 * b * lk * kv * d) * eb
    fwd_bytes = (2 * b * lq * h * d + 2 * b * lk * kv * d) * eb
    row["bound_fwd_bwd_ms"], row["bound_fwd_bwd_by"] = bound(
        3.5 * fwd_flops, fwd_bytes + bwd_bytes, "bfloat16")
    row["fp32_rel_fro_err"] = row32["rel_fro_err"]
    log("train (e): flash_attention at the training shape", json.dumps(
        {k_: row[k_] for k_ in (
            "body", "ms", "device_ms", "plain_ms", "backward_ms",
            "backward_kernel_ms", "backward_kernel_device_ms",
            "backward_kernels_device_ms", "backward_bound_ms",
            "backward_bound_by", "plain_backward_ms",
            "library_backward_ms", "library_backward_kernels_device_ms",
            "library_ms",
            "library_causal_ms", "library_causal_device_ms",
            "library_causal_fwd_bwd_ms", "library_causal_fwd_bwd_device_ms",
            "bound_ms", "bound_by", "bound_fwd_bwd_ms",
            "backward_rel_err_vs_sdpa", "backward_rel_fro_err",
            "backward_fp32_rel_fro_err", "rel_fro_err", "fp32_rel_fro_err",
            "kernels_device_ms")}))
    require(max(row["backward_rel_err_vs_sdpa"]) < 2e-2,
            f"backward vs SDPA: {row['backward_rel_err_vs_sdpa']}")
    # a tenth of the plain backward's best time on an H100 (4.785 ms)
    require(dev == "cpu" or row["backward_kernel_device_ms"] <= 0.48,
            "flash_attention_bwd at the training shape: "
            f"{row['backward_kernel_device_ms']:.4f} device ms > 0.48")
    row["backward_row"] = bwd
    return row


def phase_trainer(torch, np, ops, ref, dev="cuda", sizes=SIZES, cfg=None):
    """Phase 15: (e), (a), (b), (d), (c) in that order (memory: the
    trained params feed (d)); ``cfg`` defaults to qwen3-0.6b's."""
    from repro_torch import configs
    out, t = {}, time.perf_counter()
    out["attention"] = phase_train_attention(torch, np, ops, ref, dev=dev)
    log(f"train (e): {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    smoke = []
    for arch in configs.ALL_ARCHS:
        moe = configs.get_smoke_config(arch).moe is not None
        dispatches = (None, "dropfree") if moe else (None,)
        for dispatch in dispatches:
            smoke.append(phase_train_smoke(torch, np, ops, dev=dev,
                                           arch=arch, dispatch=dispatch))
    out["smoke"] = smoke
    log(f"train (a): {time.perf_counter() - t:.3f} s")
    # card against CPU in fp32: losses rel 1e-5; params after step 3 rel
    # 1e-4 a leaf (an entry whose gradient sits at rounding level can flip
    # the sign of its normalized Adam update, ±lr)
    for r in smoke:
        tag = f"{r['arch']} {r['dispatch']}"
        require(r["finite"], f"train (a) {tag}: non-finite loss")
        require(r["loss_rel_gap"] <= 1e-5, f"train (a) {tag}: loss gap "
                f"{r['loss_rel_gap']:.3e}")
        require(r["param_worst"][1] <= 1e-4, f"train (a) {tag}: params "
                f"{r['param_worst']}")
    for r in smoke:
        if r["dispatch"] == "dropfree":
            require(r["launches"]["grouped_matmul"] > 0, f"train (a) "
                    f"{r['arch']} drop-free: grouped_matmul never launched")
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["run"], cfg, params = phase_train_run(torch, np, ops, dev=dev,
                                              sizes=sizes, cfg=cfg)
    log(f"train (b): {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    out["compress"] = phase_train_compress(torch, np, ops, dev=dev,
                                           sizes=sizes, cfg=cfg,
                                           params=params)
    del params
    log(f"train (d): {time.perf_counter() - t:.3f} s")
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["restart"] = phase_train_restart(torch, np, ops, dev=dev,
                                         sizes=sizes, cfg=cfg)
    log(f"train (c): {time.perf_counter() - t:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the zoo conformance harness


def _zoo_counts(ops):
    return {"launches": dict(ops.LAUNCHES),
            "flash_bodies": dict(ops.FLASH_BODIES),
            "decode_bodies": dict(ops.DECODE_BODIES),
            "lowrank_rows": lowrank_rows(ops)}


def _sum_counts(parts):
    """Launch counts summed over several runs (each zeroed before, read
    after), by kernel, body and row count: nested dicts of counts, added
    key by key."""
    def add(total, part):
        for key, n in part.items():
            if isinstance(n, dict):
                add(total.setdefault(key, {}), n)
            else:
                total[key] = total.get(key, 0) + n
        return total
    total = {}
    for part in parts:
        add(total, part)
    return total


def _zoo_tokens_ok(torch, outs, b, steps, vocab):
    return all(tuple(o.shape) == (b, steps) and o.dtype == torch.int32
               and bool(((o >= 0) & (o < vocab)).all()) for o in outs)


def phase_zoo_matrix(torch, np, ops, dev="cuda", archs=None):
    """Phase 16 (a).  ``repro_torch.core.zoo.roundtrip`` for every
    registered arch on ``dev`` at the harness's fp32 smoke recipe: compress
    (4 x 32 tokens of ``repro_torch.data``), ppl dense and compressed,
    format-3 checkpoints padded (step 0) and re-sliced (step 1), three
    ``Server``s (in memory, each checkpoint through
    ``Server.from_checkpoint``) decoding 2 x 16 prompts for 12 steps, and a
    second decode of the padded checkpoint's server timed between device
    synchronizations.  Required: bit parity of both restores, token parity,
    the manifest's meta, ``rank_per_expert`` entries exactly for the MoE
    family, every decoded token in vocab, the ppl ratio within the arch's
    envelope (``tests/conformance/envelopes.json``).  ``tokens_per_s`` is
    printed beside the envelope's ``min_tokens_per_s``, a floor set for the
    JAX package on a CPU runner, and not gated.  Counts are zeroed before
    each arch and read after; their sum is (a)'s."""
    import tempfile

    from repro_torch.configs import ALL_ARCHS
    from repro_torch.core import zoo
    from repro_torch.launch import serve as TS

    on_card = torch.device(dev).type == "cuda"
    envelopes = zoo.load_envelopes(
        str(ROOT / "tests" / "conformance" / "envelopes.json"))
    b, steps = zoo.SMOKE_PROMPTS["batch"], zoo.SMOKE_DECODE_STEPS
    outs = []
    generate = TS.Server.generate

    def recorded(self, *args, **kwargs):  # every decode the contract reads
        out = generate(self, *args, **kwargs)
        outs.append(out)
        return out

    records, parts = {}, []
    TS.Server.generate = recorded
    try:
        for arch in archs or ALL_ARCHS:
            cfg = zoo.smoke_cfg(arch)
            outs.clear()
            _sync(torch, dev)
            ops.reset_launches()
            with tempfile.TemporaryDirectory() as workdir:
                rec, report = zoo.roundtrip(arch, workdir, device=dev)
            counts = _zoo_counts(ops)
            parts.append(counts)
            env = envelopes[arch]
            launches, bodies = counts["launches"], counts["flash_bodies"]
            records[arch] = {**rec, "envelope": env, **counts}
            log(f"zoo (a) {arch}: compress_wall_s {rec['compress_wall_s']:.3f}"
                f" total_wall_s {rec['total_wall_s']:.3f} tokens_per_s "
                f"{rec['tokens_per_s']:.1f} (envelope min_tokens_per_s "
                f"{env['min_tokens_per_s']}, CPU-runner floor, not gated) "
                f"ppl_ratio {rec['ppl_ratio']:.4f} (max "
                f"{env['max_ppl_ratio']}) bank_leaves {rec['bank_leaves']} "
                f"launches {json.dumps(launches)} flash bodies "
                f"{json.dumps(bodies)}")
            require(rec["bit_parity"] and rec["resliced_parity"],
                    f"zoo {arch}: restores not bit for bit: "
                    f"{rec['mismatches']}")
            require(rec["token_match"], f"zoo {arch}: the restored servers' "
                    "tokens differ from the in-memory server's")
            require(rec["checkpoint_meta_ok"],
                    f"zoo {arch}: the manifest's meta did not round-trip")
            moe = cfg.family == "moe"
            require((rec["family"] == "moe") == moe and
                    ((rec["bank_leaves"] > 0) == moe),
                    f"zoo {arch}: bank leaves {rec['bank_leaves']} for "
                    f"family {rec['family']}")
            require(len(outs) == 4 and _zoo_tokens_ok(
                torch, outs, b, steps, cfg.vocab_size),
                f"zoo {arch}: decoded tokens malformed or out of vocab")
            require(math.isfinite(rec["ppl_ratio"])
                    and rec["ppl_ratio"] <= env["max_ppl_ratio"],
                    f"zoo {arch}: ppl_ratio {rec['ppl_ratio']} > envelope "
                    f"{env['max_ppl_ratio']}")
            capacity = moe and cfg.moe.dispatch == "capacity"
            for name in ("cov_accum", "lowrank_matmul"):
                require(launches[name] > 0,
                        f"zoo {arch}: {name} never launched")
            for name in ("flash_attention", "flash_attention_bwd"):
                require((launches[name] > 0) == (cfg.attention != "none"),
                        f"zoo {arch}: {name} launched {launches[name]} "
                        "times")
            require((launches["cov_accum_banked"] > 0) == capacity,
                    f"zoo {arch}: cov_accum_banked launched "
                    f"{launches['cov_accum_banked']} times")
            # Server's cache is dense: the latent-cache decode never runs
            for name in ("grouped_matmul", "flash_decode"):
                require(launches[name] == 0,
                        f"zoo {arch}: {name} launched {launches[name]} times")
            # fp32 smoke: flash_attention's fp32 bodies alone
            require(not on_card or set(bodies) <= {"fma32", "split"},
                    f"zoo {arch}: flash_attention bodies {bodies}")
    finally:
        TS.Server.generate = generate
    total = _sum_counts(parts)
    log("zoo (a) launches over the 11 archs:", json.dumps(total))
    return {"records": records, **total}


def phase_zoo_whisper(torch, np, ops, dev="cuda", sizes=SIZES):
    """Phase 16 (b).  The harness's contract at published widths on
    whisper-base at full depth (6 encoder + 6 decoder layers, d_model 512,
    1500 frames, bf16 activations, fp32 params), composed from
    ``repro_torch.core.zoo``'s pieces: ``compress_model`` at
    ``zoo.SMOKE_COMPRESS`` on ``calibration_set`` at phase 14 (a)'s 8 x 448
    shape; ``CheckpointManager`` saves at step 0 (padded) and step 1
    (``reslice_banks=True``); ``restore_tree`` and ``bit_mismatches`` on
    both; three ``Server``s (in memory, padded, re-sliced) decoding 2 x 16
    prompts with frames for 12 steps, plus a second padded ``generate``
    timed between device synchronizations.  Required: both restores bit for
    bit, all four decodes equal and in vocab.  The compressed / dense ppl is
    printed, not enveloped (ROADMAP hazard 3k)."""
    import tempfile

    import repro_torch
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import zoo
    from repro_torch.data import calibration_set
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    cfg = configs.get_config("whisper-base")
    require((cfg.d_model, cfg.num_encoder_layers, cfg.num_layers,
             cfg.encoder_seq_len, cfg.dtype, cfg.param_dtype)
            == (512, 6, 6, 1500, "bfloat16", "float32"),
            f"zoo whisper: not the published widths: {cfg}")
    params = M.init_params(cfg, 0, device=dev)
    n_cal, l_cal = sizes["whisper_shapes"]["calib"]
    calib = calibration_set(cfg, n_cal, l_cal, device=dev)
    b, steps = zoo.SMOKE_PROMPTS["batch"], zoo.SMOKE_DECODE_STEPS
    max_len = zoo.SMOKE_PROMPTS["prompt_len"] + steps + 8
    prompts, extras = zoo.smoke_inputs(cfg, device=dev)
    out = {"calib": [n_cal, l_cal], "recipe": dict(zoo.SMOKE_COMPRESS)}
    _sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(
        params, cfg, calib, repro_torch.CompressConfig(**zoo.SMOKE_COMPRESS),
        device=dev)
    _sync(torch, dev)
    out["compress_wall_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    ppl_dense = zoo.smoke_ppl(params, cfg, device=dev)
    ppl_comp = zoo.smoke_ppl(comp, cfg, device=dev)
    out["ppl_s"] = time.perf_counter() - t1
    del params
    decodes = []
    with tempfile.TemporaryDirectory() as workdir:
        mgr = CheckpointManager(workdir, async_save=False)
        meta = {"arch": "whisper-base", "compress": dict(zoo.SMOKE_COMPRESS)}
        t1 = time.perf_counter()
        mgr.save(0, comp, blocking=True, meta=meta)
        mgr.save(1, comp, blocking=True, meta=meta, reslice_banks=True)
        out["save_s"] = time.perf_counter() - t1
        out["checkpoint_bytes"] = [_dir_bytes(pathlib.Path(workdir)
                                              / f"step_{s:09d}")
                                   for s in (0, 1)]
        bank_leaves = sum("rank_per_expert" in e
                          for e in mgr.manifest(0)["leaves"])
        t1 = time.perf_counter()
        _, padded, meta0 = mgr.restore_tree(0, device=dev)
        _, resliced, _ = mgr.restore_tree(1, device=dev)
        out["restore_s"] = time.perf_counter() - t1
        pad_bad = zoo.bit_mismatches(comp, padded)
        res_bad = zoo.bit_mismatches(comp, resliced)
        del padded, resliced
        t1 = time.perf_counter()
        servers = [TS.Server(cfg, comp, max_len=max_len, batch=b, device=dev)]
        servers += [TS.Server.from_checkpoint(cfg, workdir, step=s,
                                              max_len=max_len, batch=b,
                                              device=dev) for s in (0, 1)]
        for srv in servers:
            decodes.append(srv.generate(prompts, steps=steps,
                                        extras=extras).cpu())
        out["serve_s"] = time.perf_counter() - t1
        _sync(torch, dev)
        t1 = time.perf_counter()
        decodes.append(servers[1].generate(prompts, steps=steps,
                                           extras=extras).cpu())
        _sync(torch, dev)
        decode_wall = time.perf_counter() - t1
    counts = _zoo_counts(ops)
    launches, bodies = counts["launches"], counts["flash_bodies"]
    ranks = sorted({lin["rank"] for u in report["units"]
                    for lin in u.get("linears", [])})
    out.update({
        "bit_parity": not pad_bad, "resliced_parity": not res_bad,
        "mismatches": (pad_bad + res_bad)[:8],
        "token_match": all(torch.equal(decodes[0], d) for d in decodes[1:]),
        "checkpoint_meta_ok": meta0.get("arch") == "whisper-base",
        "bank_leaves": bank_leaves, "units": len(report["units"]),
        "ranks": ranks, "ppl_dense": ppl_dense, "ppl_compressed": ppl_comp,
        "ppl_ratio": ppl_comp / ppl_dense,
        "tokens_per_s": b * steps / max(decode_wall, 1e-9),
        "decode_s": decode_wall, "tokens_head": decodes[0][:, :6].tolist(),
        **counts})
    log("zoo (b) whisper-base at published widths:", json.dumps(out))
    log(f"zoo (b) whisper-base: compress {out['compress_wall_s']:.3f} s, "
        f"save {out['save_s']:.3f} s, restore {out['restore_s']:.3f} s, "
        f"servers {out['serve_s']:.3f} s; ppl compressed / dense "
        f"{ppl_comp:.2f} / {ppl_dense:.2f} = {out['ppl_ratio']:.4f} (not "
        f"enveloped, hazard 3k); tokens_per_s {out['tokens_per_s']:.1f}")
    require(out["bit_parity"] and out["resliced_parity"],
            f"zoo whisper: restores not bit for bit: {out['mismatches']}")
    require(out["token_match"] and _zoo_tokens_ok(
        torch, decodes, b, steps, cfg.vocab_size),
        f"zoo whisper: decodes differ or leave the vocab: {decodes}")
    require(out["checkpoint_meta_ok"] and bank_leaves == 0,
            f"zoo whisper: meta {meta0}, bank leaves {bank_leaves}")
    require(all(math.isfinite(v) for v in (ppl_dense, ppl_comp)),
            f"zoo whisper: ppl {ppl_dense} / {ppl_comp}")
    for name in ("cov_accum", "lowrank_matmul", "flash_attention",
                 "flash_attention_bwd"):
        require(launches[name] > 0, f"zoo whisper: {name} never launched")
    for name in ("grouped_matmul", "cov_accum_banked", "flash_decode"):
        require(launches[name] == 0,
                f"zoo whisper: {name} launched {launches[name]} times")
    # bf16: the encoder's and the prefills' wgmma body, decode's split body
    require(not on_card or (bodies.get("wgmma", 0) > 0
                            and bodies.get("split", 0) > 0),
            f"zoo whisper: flash_attention bodies {bodies}")
    return out


def phase_zoo(torch, np, ops, dev="cuda", sizes=SIZES, archs=None):
    """Phase 16: (a) the 11-arch matrix, (b) whisper-base at width."""
    t0 = time.perf_counter()
    matrix = phase_zoo_matrix(torch, np, ops, dev=dev, archs=archs)
    t_a = time.perf_counter() - t0
    log(f"phase 16 (a): {t_a:.3f} s")
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    whisper = phase_zoo_whisper(torch, np, ops, dev=dev, sizes=sizes)
    t_b = time.perf_counter() - t1
    log(f"phase 16 (b): {t_b:.3f} s")
    return {"matrix": matrix, "whisper": whisper,
            "seconds": {"a": t_a, "b": t_b}}


# ---------------------------------------------------------------------------
# phase 17: the autotuner


TUNER_BY_PHASE = {}


def tuner_mark():
    """The autotuner's counters now (measurements, candidates, seconds)."""
    from repro_torch.kernels import autotune
    return dict(autotune.STATS)


def tuner_log(phase, mark):
    """Log and keep the tuner's work since ``mark`` under ``phase``."""
    from repro_torch.kernels import autotune
    d = {k: autotune.STATS[k] - mark[k] for k in autotune.STATS}
    TUNER_BY_PHASE[phase] = d
    log(f"phase {phase} tuner: {d['measurements']} measurements, "
        f"{d['candidates']} candidates timed, {d['seconds']:.3f} s")


def _knobs(kernel, p):
    """The tuned fields of a plan, for the log."""
    keys = {"cov_accum": ("splits", "rows_per_split"),
            "lowrank_matmul": ("body", "splits_xv", "depth_xv", "splits_tu",
                               "depth_tu"),
            "flash_attention": ("body", "span", "spans"),
            "flash_decode": ("body", "span"),
            "grouped_matmul": ("body", "ctas")}[kernel]
    return {k: getattr(p, k) for k in keys}


def _candidate_rows(torch, kernel, cands, pick, heur, run, check, neutral,
                    dev):
    """Each candidate launched (``run(plan)`` -> outputs), held by
    ``check(outputs)`` (its max abs error, fatal past today's limit), its
    outputs bitwise equal to the heuristic's where the knob is ``neutral``,
    and timed (device ms, L2 cold); returns the rows, the heuristic's
    first."""
    plans = [c.plan for c in cands]
    require(heur in plans and pick in plans,
            f"{kernel}: the pick or the heuristic is not a candidate")
    plans.remove(heur)
    plans.insert(0, heur)
    base = run(heur)
    rows = []
    for p in plans:
        out = run(p)
        row = {"knobs": _knobs(kernel, p), "heuristic": p == heur,
               "pick": p == pick, "max_abs_err": check(out)}
        if neutral:
            row["bitwise_heuristic"] = all(
                torch.equal(a, b) for a, b in zip(out, base))
            require(row["bitwise_heuristic"], f"{kernel} {row['knobs']}: "
                    "a knob meant to keep the bits moved them")
        del out
        row["device_ms"] = device_ms(lambda: run(p))
        rows.append(row)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return rows


def _log_candidates(kernel, tag, rows, res):
    heur = rows[0]["device_ms"]
    pick = next(r for r in rows if r["pick"])
    log(f"autotune {kernel} {tag}: {len(rows)} candidates, heuristic "
        f"{heur:.4f} ms, pick {pick['knobs']} {pick['device_ms']:.4f} ms "
        f"({res.source})")
    for r in rows:
        log(f"autotune {kernel} {tag}   {json.dumps(r)}")


def phase_autotune(torch, np, ops, ref, dev="cuda", sizes=SIZES):
    """Phase 17: (a) every candidate of each lattice at the main path's
    shapes, launched and held against the plain version at today's limit
    (and bitwise against the heuristic's where its knob keeps the bits),
    timed beside the heuristic's, the pick named (the wrapper's own launch
    bitwise the pick's); kimi-k2's bank tap with its 32 per-bank launches
    timed; (b) a second call is an in-memory hit and a child process given
    the same cache reads the same plans from it; (c) under
    ``REPRO_AUTOTUNE=heuristic`` each shape gets its kernel's ``plan()``.
    On the CPU (a rehearsal) ``run`` is the plan's emulation."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import cov_accum as cov
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import lowrank_matmul as low
    on_card = torch.device(dev).type == "cuda"
    bf16 = torch.bfloat16
    out = {"lowrank_matmul": [], "cov_accum": [], "flash_attention": [],
           "flash_decode": [], "grouped_matmul": []}
    heuristic_args = []     # (entry point, args, kwargs, parent plan)

    def scratch(p):
        return torch.empty(max(p.scratch_floats, 1), dtype=torch.float32,
                           device=dev)

    # lowrank_matmul: each product's splits
    for n, k, m in sizes["autotune_lowrank"]:
        for t_rows in sizes["autotune_T"]:
            gen = torch.Generator(device=dev).manual_seed(n + k + m + t_rows)
            x = torch.randn(t_rows, n, generator=gen, device=dev).to(bf16)
            v = (torch.randn(n, k, generator=gen, device=dev)
                 / math.sqrt(n)).to(bf16)
            u = (torch.randn(k, m, generator=gen, device=dev)
                 / math.sqrt(k)).to(bf16)
            want = ref.lowrank_matmul_ref(x, v, u)
            lim = 2e-2 * float(want.float().abs().max())
            y_wrapper = ops.lowrank_matmul(x, v, u)
            res = autotune.lowrank_plan(t_rows, n, k, m, bf16, device=dev)
            heur = low.plan(t_rows, n, k, m, bf16)
            heuristic_args.append((autotune.lowrank_plan,
                                   (t_rows, n, k, m, bf16), {}, heur))
            cands = [c for prod in ("xv", "tu")
                     for c in autotune.lowrank_candidates(
                         t_rows, n, k, m, bf16, product=prod)]
            cands = list({c.plan: c for c in cands}.values())
            if res.plan not in [c.plan for c in cands]:
                cands.append(autotune.Candidate(res.plan, 0, 0.0))

            def run(p, x=x, v=v, u=u):
                if not on_card:
                    return low.emulate(p, x, v, u)[:1]
                t = torch.empty((p.rows, p.k), dtype=bf16, device=dev)
                y = torch.empty((p.rows, p.m), dtype=bf16, device=dev)
                low.launch(p, x, v, u, t, y, None, None, scratch(p))
                return (y,)

            def check(o, want=want, lim=lim, tag=(n, k, m, t_rows)):
                mae = float((o[0].float() - want.float()).abs().max())
                require(mae <= lim, f"autotune lowrank_matmul {tag}: max abs "
                        f"err {mae:.3e} > {lim:.3e}")
                return mae

            if on_card:
                require(torch.equal(y_wrapper, run(res.plan)[0]),
                        f"lowrank_matmul {(n, k, m, t_rows)}: the wrapper "
                        "did not launch the pick")
            rows = _candidate_rows(
                torch, "lowrank_matmul", cands, res.plan, heur, run, check,
                heur.body == "wgmma", dev)
            _log_candidates("lowrank_matmul", f"({n}, {k}, {m}) T {t_rows}",
                            rows, res)
            out["lowrank_matmul"].append({
                "shape": [t_rows, n, k, m], "body": heur.body,
                "source": res.source, "candidates": rows})
            del x, v, u, want, y_wrapper
    # cov_accum: the token slices
    for t_rows, n in sizes["autotune_cov"]:
        gen = torch.Generator(device=dev).manual_seed(n + t_rows)
        x = torch.randn(t_rows, n, generator=gen, device=dev).to(bf16)
        xp = (x.float() + 0.1 * torch.randn(t_rows, n, generator=gen,
                                            device=dev)).to(bf16)
        want = ref.cov_accum_ref(x, xp)
        ops.cov_accum(x, xp)
        res = autotune.cov_plan(t_rows, n, bf16, device=dev)
        heur = cov.plan(t_rows, n, bf16)
        heuristic_args.append((autotune.cov_plan, (t_rows, n, bf16), {},
                               heur))
        cands = autotune.cov_candidates(t_rows, n, bf16)

        def run(p, x=x, xp=xp):
            if not on_card:
                return cov.emulate(p, x, xp)
            outs = tuple(torch.empty((1, p.n, p.n), dtype=torch.float32,
                                     device=dev) for _ in range(3))
            cov.launch(p, x[None], xp[None], *outs, scratch(p),
                       accumulate=False)
            return tuple(o[0] for o in outs)

        def check(o, want=want, tag=(t_rows, n)):
            err = max(rel_fro(g, w) for g, w in zip(o, want))
            require(err <= 5e-5, f"autotune cov_accum {tag}: rel err "
                    f"{err:.3e} > 5e-05")
            require(torch.equal(o[0], o[0].T) and torch.equal(o[2], o[2].T),
                    f"autotune cov_accum {tag}: xx / xpxp not symmetric")
            return max(float((g - w).abs().max()) for g, w in zip(o, want))

        rows = _candidate_rows(torch, "cov_accum", cands, res.plan, heur,
                               run, check, False, dev)
        _log_candidates("cov_accum", f"T {t_rows} n {n}", rows, res)
        out["cov_accum"].append({"shape": [t_rows, n], "source": res.source,
                                 "candidates": rows})
        del x, xp, want
    # flash_attention: the split bodies' spans (the tile bodies: one plan)
    cases = {c[0]: c for c in sizes["flash_attention"]}
    for name in sizes["autotune_flash"]:
        case = cases[name]
        _, b, h, kv, lq, lk, d, causal, window, softcap, _ = case
        q, k, v, offs, kw = _flash_inputs(torch, np, case, bf16, dev)
        want = ref.flash_attention_ref(q, k, v, **kw)
        got = ops.flash_attention(q, k, v, **kw)
        res = autotune.flash_plan(b, lq, lk, h, kv, d, bf16, causal=causal,
                                  window=window, device=dev)
        heur = fa.plan(b, lq, lk, h, kv, d, bf16, causal=causal,
                       window=window)
        heuristic_args.append((autotune.flash_plan,
                               (b, lq, lk, h, kv, d, bf16),
                               dict(causal=causal, window=window), heur))
        cands = autotune.flash_candidates(b, lq, lk, h, kv, d, bf16,
                                          causal=causal, window=window)
        q_off = kw["q_offset"] if torch.is_tensor(kw["q_offset"]) else None

        def run(p, q=q, k=k, v=v, q_off=q_off, offs=offs):
            if not on_card:
                return (fa.emulate(dataclasses.replace(p, offsets=tuple(
                    offs)), q, k, v, scale=1.0 / math.sqrt(p.d)),)
            o = torch.empty_like(q)
            fa.launch(p, q, k, v, o, q_off, offs[0] if q_off is None else 0,
                      scale=1.0 / math.sqrt(p.d), softcap=softcap,
                      scratch=scratch(p) if p.scratch_floats else None)
            return (o,)

        def check(o, want=want, name=name):
            err = rel_fro(o[0], want)
            require(err <= 1e-2, f"autotune flash_attention {name}: rel err "
                    f"{err:.3e} > 1e-02")
            return float((o[0].float() - want.float()).abs().max())

        if on_card:
            require(torch.equal(got, run(res.plan)[0]), f"flash_attention "
                    f"{name}: the wrapper did not launch the pick")
        rows = _candidate_rows(torch, "flash_attention", cands, res.plan,
                               heur, run, check, False, dev)
        _log_candidates("flash_attention", name, rows, res)
        out["flash_attention"].append({"case": name, "body": heur.body,
                                       "source": res.source,
                                       "candidates": rows})
    # flash_decode: SPAN is compiled in, one plan
    dcases = {c[0]: c for c in sizes["flash_decode"]}
    for name in sizes["autotune_decode"]:
        case = dcases[name]
        args, lens = _decode_inputs(torch, np, case, bf16, dev)
        want = ref.flash_decode_ref(*args)
        ops.flash_decode(*args)
        _, b, h, kv, d, rk, rv, l = case[:8]
        res = autotune.flash_decode_plan(b, l, h, kv, d, rk, rv, bf16,
                                         device=dev)
        heur = fd.plan(b, l, h, kv, d, rk, rv, bf16)
        heuristic_args.append((autotune.flash_decode_plan,
                               (b, l, h, kv, d, rk, rv, bf16), {}, heur))
        cands = autotune.flash_decode_candidates(b, l, h, kv, d, rk, rv, bf16)

        def run(p, args=args):
            if not on_card:
                return (fd.emulate(p, *args),)
            o = torch.empty_like(args[0])
            fd.launch(p, *args, o, torch.empty(p.scratch_floats,
                                               dtype=torch.float32,
                                               device=dev), rope=True)
            return (o,)

        def check(o, want=want, name=name):
            err = rel_fro(o[0], want)
            require(err <= 5e-3, f"autotune flash_decode {name}: rel err "
                    f"{err:.3e} > 5e-03")
            return float((o[0].float() - want.float()).abs().max())

        rows = _candidate_rows(torch, "flash_decode", cands, res.plan, heur,
                               run, check, False, dev)
        _log_candidates("flash_decode", name, rows, res)
        out["flash_decode"].append({"case": name, "source": res.source,
                                    "candidates": rows})
    # grouped_matmul: the persistent blocks
    gcases = {c[0]: c for c in sizes["grouped"]}
    for name in sizes["autotune_grouped"]:
        case = gcases[name]
        _, m, d, f, e = case
        sizes_np, gs, x, w, _ = _grouped_inputs(torch, np, case, bf16, dev)
        want = ref.grouped_matmul_ref(x, w, gs).to(bf16)
        got = ops.grouped_matmul(x, w, gs)
        res = autotune.grouped_plan(m, d, f, e, bf16, device=dev)
        heur = gm.plan(m, d, f, e, bf16)
        heuristic_args.append((autotune.grouped_plan, (m, d, f, e, bf16), {},
                               heur))
        cands = autotune.grouped_candidates(m, d, f, e, bf16)

        def run(p, x=x, w=w, gs=gs, sizes_np=sizes_np):
            if not on_card:
                return (gm.emulate(p, x, w, sizes_np.tolist()),)
            y = torch.empty((p.rows, p.n), dtype=bf16, device=dev)
            gm.launch(p, x, w, gs, y)
            return (y,)

        def check(o, want=want, name=name):
            err = rel_fro(o[0], want)
            require(err <= 1e-2, f"autotune grouped_matmul {name}: rel err "
                    f"{err:.3e} > 1e-02")
            return float((o[0].float() - want.float()).abs().max())

        if on_card:
            require(torch.equal(got, run(res.plan)[0]), f"grouped_matmul "
                    f"{name}: the wrapper did not launch the pick")
        rows = _candidate_rows(torch, "grouped_matmul", cands, res.plan,
                               heur, run, check, True, dev)
        _log_candidates("grouped_matmul", name, rows, res)
        out["grouped_matmul"].append({"case": name, "source": res.source,
                                      "candidates": rows})
        del x, w, want, got
    # kimi-k2's bank tap: one plan (its items fill the card without a
    # split), timed beside the drop-free route's 32 per-bank launches
    e, c, n = sizes["autotune_bank"]
    _, x, xp = _banked_inputs(torch, e, c, n, bf16, dev, 7)
    heur = cov.plan(c, n, bf16, banks=e)
    cands = autotune.cov_candidates(c, n, bf16, banks=e)
    heuristic_args.append((autotune.cov_plan, (c, n, bf16, e), {}, heur))
    want = ref.cov_accum_banked_ref(x, xp)
    got = ops.cov_accum_banked(x, xp)
    res = autotune.cov_plan(c, n, bf16, banks=e, device=dev)
    err = max(rel_fro(g, w) for g, w in zip(got, want))
    require(err <= 5e-5, f"autotune cov_accum_banked {e}x{c}x{n}: rel err "
            f"{err:.3e} > 5e-05")
    del want
    accs = tuple(torch.zeros_like(g) for g in got)
    per_bank = [ops.cov_accum(x[i], xp[i], acc=tuple(a[i] for a in accs))
                for i in range(e)]
    same = all(torch.equal(g, a) for g, a in zip(got, accs))
    del per_bank
    # both added into accumulators (acc=), as calibration runs them
    bank = {"shape": [e, c, n], "candidates": len(cands),
            "knobs": _knobs("cov_accum", res.plan), "source": res.source,
            "rel_fro_err": err, "per_bank_bitwise_equal": same,
            "device_ms": device_ms(lambda: ops.cov_accum_banked(
                x, xp, acc=got)),
            "per_bank_device_ms": device_ms(lambda: [
                ops.cov_accum(x[i], xp[i], acc=tuple(a[i] for a in accs))
                for i in range(e)])}
    log("autotune cov_accum_banked kimi bank tap", json.dumps(bank))
    out["cov_accum_banked"] = bank
    del x, xp, accs, got
    if on_card:
        torch.cuda.empty_cache()
    # (b) the caches: in memory, then a child process on the cache file
    mark = dict(autotune.STATS)
    again = [fn(*a, device=dev, **kw) for fn, a, kw, _ in heuristic_args]
    require(dict(autotune.STATS) == mark, "autotune: a second call measured")
    # (entry point, args, kwargs, plan, whether its lattice was tuned)
    measured = [(fn.__name__, a, kw, r.plan, r.source != "heuristic")
                for (fn, a, kw, _), r in zip(heuristic_args, again)]
    cache = {"in_memory_hits": len(again), "path": os.environ.get(
        "REPRO_AUTOTUNE_CACHE")}
    if on_card:
        child = (
            "import json, sys, torch\n"
            f"sys.path.insert(0, {str(SRC)!r})\n"
            "from repro_torch.kernels import autotune as A\n"
            "bf16 = torch.bfloat16\n"
            "out = []\n"
            "for name, a, kw in json.loads(sys.argv[1]):\n"
            "    a = [bf16 if x == 'bf16' else x for x in a]\n"
            "    r = getattr(A, name)(*a, device='cuda', **kw)\n"
            "    out.append([r.source, repr(r.plan)])\n"
            "print(json.dumps(out))\n")
        spec = [(name, ["bf16" if x is bf16 else x for x in a], kw)
                for name, a, kw, _, _ in measured]
        proc = subprocess.run([sys.executable, "-c", child, json.dumps(spec)],
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ))
        require(proc.returncode == 0, f"autotune child: {proc.stderr[-2000:]}")
        got_child = json.loads(proc.stdout.splitlines()[-1])
        tuned = [i for i, m in enumerate(measured) if m[4]]
        require(tuned and all(got_child[i][0] == "cache" for i in tuned),
                f"autotune child: sources {[g[0] for g in got_child]}")
        require(all(got_child[i][1] == repr(measured[i][3])
                    for i in range(len(measured))),
                "autotune child: another plan than this process's")
        cache.update(child_cache_hits=len(tuned), child_plans_equal=True)
    log("autotune (b) caches", json.dumps(cache))
    out["cache"] = cache
    # (c) the heuristic, pinned from the environment: the parent's plan()
    before = os.environ.get("REPRO_AUTOTUNE")
    os.environ["REPRO_AUTOTUNE"] = "heuristic"
    try:
        diff = [(fn.__name__, a) for fn, a, kw, want in heuristic_args
                if fn(*a, device=dev, **kw).plan != want]
    finally:
        if before is None:
            os.environ.pop("REPRO_AUTOTUNE")
        else:
            os.environ["REPRO_AUTOTUNE"] = before
    require(not diff, f"autotune: REPRO_AUTOTUNE=heuristic gave another "
            f"plan than plan() at {diff}")
    out["heuristic"] = {"shapes": len(heuristic_args), "equal": True}
    log("autotune (c) heuristic: plan() field for field at",
        len(heuristic_args), "shapes")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("lowrank", "cov", "grouped",
                                       "attention", "decode", "kimi", "ssm",
                                       "multimodal", "train", "zoo",
                                       "autotune"),
                    help="phases 1-2 and lowrank_matmul's (cov_accum's, "
                    "grouped_matmul's, flash_attention's, flash_decode's) "
                    "rows of phase 3; kimi: phases 1-2, phase 4's kimi-k2 "
                    "smoke runs and phase 12; ssm: phases 1-2, phase 4's "
                    "falcon-mamba and zamba2 smoke runs and phase 13; "
                    "multimodal: phases 1-2, phase 3's whisper and "
                    "phi-3-vision rows, ROADMAP 3j's refine-off check, phase "
                    "4's whisper and phi-3-vision smoke runs and phase 14; "
                    "train: phases 1-2 and phase 15; zoo: phases 1-2 "
                    "and phase 16; autotune: phases 1-2 and phase 17")
    ap.add_argument("--cases", help="with --only attention: the "
                    "flash_attention cases to run, comma-separated (their "
                    "rows, chunk and profiled checks alone)")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    OUT.mkdir(exist_ok=True)
    global LOG
    # a partial run (--only) names its log after its part
    tag = "" if args.only is None else f"_{args.only}"
    LOG = OUT / f"chip_smoke{tag}.log"
    LOG.write_text("")
    import numpy as np

    import repro_torch._fp32  # noqa: F401  (turns TF32 off)
    from repro_torch.kernels import autotune, build, ops, ref

    # every run measures its own picks: a fresh cache file, removed at exit
    import atexit
    import shutil
    import tempfile
    tune_dir = tempfile.mkdtemp(prefix="autotune-")
    atexit.register(shutil.rmtree, tune_dir, ignore_errors=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tune_dir, "tune.json")
    autotune.reset()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    require(card, f"nvidia-smi gave nothing: {smi.stderr}")
    print(card, flush=True)
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; tf32 {torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.3f} s ({build.library_path()})")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log("build: nvcc", nvcc[-1] if nvcc else "?")
    for line in build.build_log().splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "Performance Loss" in line):
            log("build:", line.strip())
    usage = ptxas_usage(build.build_log())
    for kernel, symbol in (("flash_attention", "flash_wgmma"),
                           ("flash_decode", "fdec_keys_wgmma")):
        wg_usage = {fn: u for fn, u in usage.items() if symbol in fn}
        log(f"build: {kernel} wgmma body (registers, spill stores, spill "
            "loads):", json.dumps(wg_usage))
        require(wg_usage and not any(u[1] or u[2]
                                     for u in wg_usage.values()),
                f"the {kernel} wgmma body spills: {wg_usage}")
    # the wgmma body's D-64 schedule overlaps only while ptxas keeps its
    # wgmma asynchronous: no serialization warning may name the body
    serial = [line.strip() for line in build.build_log().splitlines()
              if "Performance Loss" in line and "flash_wgmma" in line]
    require(not serial, f"ptxas serializes flash_attention's wgmma body: "
            f"{serial}")
    # flash_attention's backward: its wgmma bodies keep the dK / dV / dQ
    # accumulators in registers, and ptxas keeps their wgmma asynchronous
    bwd_usage = {fn: u for fn, u in usage.items()
                 if "bwd_kv_wgmma" in fn or "bwd_q_wgmma" in fn}
    log("build: flash_attention_bwd wgmma bodies (registers, spill stores, "
        "spill loads):", json.dumps(bwd_usage))
    require(bwd_usage and not any(u[1] or u[2] for u in bwd_usage.values()),
            f"the flash_attention_bwd wgmma bodies spill: {bwd_usage}")
    serial = [line.strip() for line in build.build_log().splitlines()
              if "Performance Loss" in line and "flash_attention_bwd" in line]
    require(not serial, f"ptxas serializes flash_attention_bwd's wgmma: "
            f"{serial}")
    # flash_attention's tensor-core GQA decode keeps O in registers
    mma_usage = {fn: u for fn, u in usage.items() if "flash_split_mma" in fn}
    log("build: flash_attention split_mma body (registers, spill stores, "
        "spill loads):", json.dumps(mma_usage))
    require(mma_usage and not any(u[1] or u[2] for u in mma_usage.values()),
            f"the flash_attention split_mma body spills: {mma_usage}")
    from repro_torch.kernels import lowrank_matmul as low
    hgmma = sass_report(build.library_path())
    if hgmma is None:
        log("sass: cuobjdump not found; HGMMA not checked")
    else:
        wg = {fn: c for fn, c in hgmma.items() if "wgmma" in fn}
        log("sass: HGMMA instructions by kernel:", json.dumps(
            {fn: c for fn, c in hgmma.items() if c} or "none"))
        require(wg and all(wg.values()),
                f"the wgmma body's SASS holds no HGMMA: {wg}")
    if args.only in ("kimi", "ssm", "multimodal", "train", "zoo"):
        count_plain_backward(ref)
    if args.only is not None:
        if args.only == "lowrank":
            rows = {"lowrank_matmul": phase_lowrank(torch, ops, ref)}
        elif args.only == "cov":
            rows = {"cov_accum": phase_cov(torch, ops, ref),
                    "cov_accum_banked": phase_cov_banked(torch, ops, ref)}
        elif args.only == "attention":
            sizes = dict(SIZES)
            if args.cases:
                names = set(args.cases.split(","))
                for key in ("flash_attention", "flash_attention_ragged",
                            "flash_attention_bwd_dead"):
                    sizes[key] = tuple(c for c in SIZES[key]
                                       if c[0] in names)
                for key in ("flash_attention_rows_cases",
                            "flash_attention_profiled"):
                    sizes[key] = tuple(n for n in SIZES[key] if n in names)
            fa_rows, fa_checks = phase_flash_attention(torch, np, ops, ref,
                                                       sizes=sizes)
            rows = {"flash_attention": fa_rows,
                    "flash_attention_checks": fa_checks}
        elif args.only == "decode":
            fd_rows, fd_checks = phase_decode_kernels(torch, np, ops, ref)
            rows = {"flash_decode": fd_rows,
                    "flash_decode_checks": fd_checks}
        elif args.only == "kimi":
            t0 = time.perf_counter()
            rows = {"kimi": phase_kimi(torch, np, ops)}
            log(f"phase 12: {time.perf_counter() - t0:.3f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            rows["smoke_kimi"] = {d: phase_smoke_kimi(torch, np, dispatch=d)
                                  for d in ("capacity", "dropfree")}
            log(f"phase 4 (kimi): {time.perf_counter() - t0:.3f} s")
        elif args.only == "multimodal":
            t0 = time.perf_counter()
            mm = dict(SIZES)
            mm["flash_attention"] = tuple(
                c for c in SIZES["flash_attention"]
                if c[0].startswith(("whisper", "vision")))
            mm["flash_attention_ragged"] = ()
            mm["flash_attention_rows_cases"] = ()
            mm["flash_decode"] = tuple(
                c for c in SIZES["flash_decode"]
                if c[0] in ("whisper", "vision", "ragged_d96",
                            "ragged_d64_norope"))
            mm["flash_decode_alone"] = ("vision",)
            fa_rows, fd_rows, fa_checks, fd_checks = (
                phase_attention_kernels(torch, np, ops, ref, sizes=mm))
            rows = {"flash_attention": fa_rows,
                    "flash_attention_checks": fa_checks,
                    "flash_decode": fd_rows,
                    "flash_decode_checks": fd_checks}
            log(f"phase 3 (multimodal): {time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            rows["refine_off_3j"] = {
                arch: phase_refine_off(torch, np, arch=arch,
                                       calib_shape=shape)
                for arch, shape in SIZES["refine_off_3j"]}
            log(f"3j: {time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            # whisper at the JAX data's 0.02 scales (hazard 3k), printed
            rows["smoke_whisper_unconditioned"] = phase_smoke_multimodal(
                torch, np, arch="whisper-base",
                calib_shape=SIZES["smoke_calib"], conditioned=False)
            rows["smoke_mm"] = {
                arch: phase_smoke_multimodal(
                    torch, np, arch=arch, calib_shape=SIZES["smoke_calib"])
                for arch in SIZES["smoke_mm_archs"]}
            log(f"phase 4 (multimodal): {time.perf_counter() - t0:.3f} s")
            for key, arch in (("whisper", "whisper-base"),
                              ("vision", "phi-3-vision-4.2b")):
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                rows[key] = phase_multimodal(torch, np, ops, arch=arch)
                log(f"phase 14 ({key}): {time.perf_counter() - t0:.3f} s")
        elif args.only == "train":
            t0 = time.perf_counter()
            rows = {"train": phase_trainer(torch, np, ops, ref)}
            log(f"phase 15: {time.perf_counter() - t0:.3f} s")
        elif args.only == "zoo":
            t0 = time.perf_counter()
            rows = {"zoo": phase_zoo(torch, np, ops)}
            log(f"phase 16: {time.perf_counter() - t0:.3f} s")
        elif args.only == "autotune":
            t0, tm = time.perf_counter(), tuner_mark()
            rows = {"autotune": phase_autotune(torch, np, ops, ref)}
            log(f"phase 17: {time.perf_counter() - t0:.3f} s")
            tuner_log("17", tm)
        elif args.only == "ssm":
            t0 = time.perf_counter()
            rows = {"smoke_ssm": {arch: phase_smoke(
                torch, np, arch=arch, calib_shape=SIZES["smoke_calib_ssm"])
                for arch in SIZES["smoke_ssm_archs"]}}
            log(f"phase 4 (ssm): {time.perf_counter() - t0:.3f} s")
            for key, arch in (("zamba2", "zamba2-7b"),
                              ("falcon", "falcon-mamba-7b")):
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                rows[key] = phase_ssm(torch, np, ops, arch=arch)
                log(f"phase 13 ({key}): {time.perf_counter() - t0:.3f} s")
        else:
            gm_rows, gm_back = phase_grouped_kernels(torch, np, ops, ref)
            rows = {"grouped_matmul": gm_rows,
                    "grouped_matmul_backward": gm_back}
        log(f"tuner whole run: {autotune.STATS['measurements']} "
            f"measurements, {autotune.STATS['candidates']} candidates "
            f"timed, {autotune.STATS['seconds']:.3f} s")
        if PLAIN_BWD["fn"] is not None:
            rows["plain_backward_cuda_calls"] = PLAIN_BWD["cuda_calls"]
            log("the plain attention backward on CUDA tensors outside this "
                f"script's comparisons: {PLAIN_BWD['cuda_calls']} calls")
            require(PLAIN_BWD["cuda_calls"] == 0, "the plain attention "
                    "backward ran on the card")
        with open(OUT / f"chip_smoke{tag}.json", "w") as f:
            json.dump({"card": card, **rows, "tuner": dict(autotune.STATS)},
                      f, indent=1)
        log(f"whole run: {time.perf_counter() - t_run:.3f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. kernels
    t0, tm = time.perf_counter(), tuner_mark()
    cov_rows, low_rows = phase_kernels(torch, ops, ref)
    banked_rows = phase_cov_banked(torch, ops, ref)
    fa_rows, fd_rows, fa_checks, fd_checks = phase_attention_kernels(
        torch, np, ops, ref)
    gm_rows, gm_back = phase_grouped_kernels(torch, np, ops, ref)
    log(f"phase 3: {time.perf_counter() - t0:.3f} s")
    tuner_log("3", tm)
    # 4. smoke parity; from here on every attention backward on the card
    # must be the kernel: the plain one is counted
    count_plain_backward(ref)
    t0, tm = time.perf_counter(), tuner_mark()
    smoke = phase_smoke(torch, np)
    smoke["moe"] = phase_smoke_moe(torch, np)
    smoke["moe_capacity"] = phase_smoke_moe_capacity(torch, np)
    smoke["archs"] = {arch: phase_smoke(torch, np, arch=arch,
                                        calib_shape=SIZES["smoke_calib"])
                      for arch in SIZES["smoke_archs"]}
    smoke["adaptive"] = phase_smoke_adaptive(torch, np)
    smoke["moe_adaptive"] = phase_smoke_moe_adaptive(torch, np)
    smoke["kimi"] = {d: phase_smoke_kimi(torch, np, dispatch=d)
                     for d in ("capacity", "dropfree")}
    smoke["ssm"] = {arch: phase_smoke(torch, np, arch=arch,
                                      calib_shape=SIZES["smoke_calib_ssm"])
                    for arch in SIZES["smoke_ssm_archs"]}
    smoke["multimodal"] = {
        arch: phase_smoke_multimodal(torch, np, arch=arch,
                                     calib_shape=SIZES["smoke_calib"])
        for arch in SIZES["smoke_mm_archs"]}
    log(f"phase 4: {time.perf_counter() - t0:.3f} s")
    tuner_log("4", tm)
    # 5. main path: compression
    t0, tm = time.perf_counter(), tuner_mark()
    main_run, cfg, params, comp = phase_main(torch, ops)
    log(f"phase 5: {time.perf_counter() - t0:.3f} s")
    tuner_log("5", tm)
    # 6. main path: serving
    t0, tm = time.perf_counter(), tuner_mark()
    serve_run = phase_serve(torch, np, ops, cfg, params, comp)
    log(f"phase 6: {time.perf_counter() - t0:.3f} s")
    tuner_log("6", tm)
    del params, comp
    torch.cuda.empty_cache()
    # 7. MoE path: drop-free compression of deepseek-v2-lite
    t0, tm = time.perf_counter(), tuner_mark()
    moe_run, moe_cfg, moe_comp = phase_moe(torch, ops)
    log(f"phase 7: {time.perf_counter() - t0:.3f} s")
    tuner_log("7", tm)
    torch.cuda.empty_cache()
    # 8. MoE path: the config's own capacity dispatch
    t0, tm = time.perf_counter(), tuner_mark()
    moe_cap_run, cap_cfg, cap_comp = phase_moe(torch, ops,
                                               dispatch="capacity")
    log(f"phase 8: {time.perf_counter() - t0:.3f} s")
    tuner_log("8", tm)
    torch.cuda.empty_cache()
    # 9. serving deepseek-v2-lite: phase 7's and phase 8's compressed models
    t0, tm = time.perf_counter(), tuner_mark()
    serve_moe = {}
    for c, p in ((moe_cfg, moe_comp), (cap_cfg, cap_comp)):
        serve_moe[c.moe.dispatch] = phase_serve_moe(torch, np, ops, c, p)
    del moe_comp, cap_comp
    log(f"phase 9: {time.perf_counter() - t0:.3f} s")
    tuner_log("9", tm)
    moe_paths = {f"serve_moe_{run}_{d}": serve_moe[d][run]
                 for d in ("dropfree", "capacity")
                 for run in ("server", "engine")}
    torch.cuda.empty_cache()
    # 10. gemma3-1b at published widths: compression and serving
    t0, tm = time.perf_counter(), tuner_mark()
    gemma = phase_gemma(torch, np, ops)
    log(f"phase 10: {time.perf_counter() - t0:.3f} s")
    tuner_log("10", tm)
    gemma_paths = {"compress_gemma": gemma["compress"],
                   "serve_gemma_server": gemma["server"],
                   "serve_gemma_engine": gemma["engine"]}
    torch.cuda.empty_cache()
    # 11. calibration policies: adaptive hybrid llama through a checkpoint,
    # then deepseek's capacity banks replayed by hybrid calibration
    t0, tm = time.perf_counter(), tuner_mark()
    policies = phase_policies(torch, np, ops, uniform=main_run["compressed"])
    log(f"phase 11 (a): {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    policies_moe = phase_policies_moe(torch, ops,
                                      uniform=moe_cap_run["compressed"])
    log(f"phase 11 (b): {time.perf_counter() - t1:.3f} s")
    log(f"phase 11: {time.perf_counter() - t0:.3f} s")
    tuner_log("11", tm)
    policy_paths = {"compress_adaptive": policies,
                    "serve_ckpt_server": policies["server"],
                    "serve_ckpt_engine": policies["engine"],
                    "compress_moe_hybrid": policies_moe}
    torch.cuda.empty_cache()
    # 12. kimi-k2 at published widths: compression and serving
    t0, tm = time.perf_counter(), tuner_mark()
    kimi = phase_kimi(torch, np, ops)
    log(f"phase 12: {time.perf_counter() - t0:.3f} s")
    tuner_log("12", tm)
    kimi_paths = {"compress_kimi": kimi["compress"],
                  "serve_kimi_server": kimi["server"],
                  "serve_kimi_engine": kimi["engine"],
                  "serve_kimi_engine_dense": kimi["engine_dense"]}
    torch.cuda.empty_cache()
    # 13. the SSM family at published widths: zamba2-7b (Mamba2 + the
    # weight-shared attention block), then falcon-mamba-7b (Mamba1)
    t0, tm = time.perf_counter(), tuner_mark()
    zamba2 = phase_ssm(torch, np, ops, arch="zamba2-7b")
    log(f"phase 13 (a): {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    falcon = phase_ssm(torch, np, ops, arch="falcon-mamba-7b")
    log(f"phase 13 (b): {time.perf_counter() - t1:.3f} s")
    log(f"phase 13: {time.perf_counter() - t0:.3f} s")
    tuner_log("13", tm)
    ssm_paths = {"compress_zamba2": zamba2["compress"],
                 "serve_zamba2_server": zamba2["server"],
                 "serve_zamba2_engine": zamba2["engine"],
                 "serve_zamba2_engine_dense": zamba2["engine_dense"],
                 "compress_falcon": falcon["compress"],
                 "serve_falcon_server": falcon["server"]}
    torch.cuda.empty_cache()
    # 14. the multimodal archs at published widths: whisper-base at full
    # depth, then phi-3-vision-4.2b at a cut depth
    t0, tm = time.perf_counter(), tuner_mark()
    whisper = phase_multimodal(torch, np, ops, arch="whisper-base")
    log(f"phase 14 (a): {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    vision = phase_multimodal(torch, np, ops, arch="phi-3-vision-4.2b")
    log(f"phase 14 (b): {time.perf_counter() - t1:.3f} s")
    log(f"phase 14: {time.perf_counter() - t0:.3f} s")
    tuner_log("14", tm)
    mm_paths = {}
    for tag, run in (("whisper", whisper), ("vision", vision)):
        mm_paths[f"compress_{tag}"] = run["compress"]
        for key in ("server", "engine", "engine_dense"):
            mm_paths[f"serve_{tag}_{key}"] = run[key]
    torch.cuda.empty_cache()
    # 15. the trainer: qwen3-0.6b trained at full width, restarted, then
    # compressed and served; every arch's smoke train step card vs CPU
    t0, tm = time.perf_counter(), tuner_mark()
    trainer = phase_trainer(torch, np, ops, ref)
    log(f"phase 15: {time.perf_counter() - t0:.3f} s")
    tuner_log("15", tm)
    train_paths = {"train": trainer["run"],
                   "compress_trained": trainer["compress"]["aa_svd"],
                   "compress_trained_naive": trainer["compress"]["naive"],
                   "serve_trained_server": trainer["compress"]["serve"]}
    torch.cuda.empty_cache()
    # 16. the zoo conformance harness: every arch's smoke round trip, then
    # whisper-base's at published widths
    t0, tm = time.perf_counter(), tuner_mark()
    zoo = phase_zoo(torch, np, ops)
    log(f"phase 16: {time.perf_counter() - t0:.3f} s")
    tuner_log("16", tm)
    zoo_paths = {"zoo_smoke": zoo["matrix"], "zoo_whisper": zoo["whisper"]}
    torch.cuda.empty_cache()
    # 17. the autotuner: every candidate at the main path's shapes, the
    # caches, the heuristic pinned from the environment
    t0, tm = time.perf_counter(), tuner_mark()
    tuned = phase_autotune(torch, np, ops, ref)
    log(f"phase 17: {time.perf_counter() - t0:.3f} s")
    tuner_log("17", tm)
    log(f"tuner whole run: {autotune.STATS['measurements']} measurements, "
        f"{autotune.STATS['candidates']} candidates timed, "
        f"{autotune.STATS['seconds']:.3f} s")
    log("the plain attention backward on CUDA tensors outside this script's "
        f"comparisons, phases 4-17: {PLAIN_BWD['cuda_calls']} calls")
    require(PLAIN_BWD["cuda_calls"] == 0, "the plain attention backward ran "
            f"on the card {PLAIN_BWD['cuda_calls']} times")

    def timing(row):
        return {"max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"], "dtype": row["dtype"],
                **{key: row[key] for key in (
                    "device_ms", "library_device_ms", "library_causal_ms",
                    "library_causal_device_ms", "body", "bound_tc_ms",
                    "bound_tc_by", "kernels_device_ms") if key in row}}

    bwd_rows = [r for r in fa_checks
                if r.get("kernel") == "flash_attention_bwd"]

    def entry(name, source, replaces, rows, path):
        # the timed bf16 row (flash_decode also times its fp32 row)
        head = next(r for r in rows if "ms" in r
                    and r["dtype"] == "bfloat16")
        by_path = {"compress": main_run["launches"][name],
                   "serve_server": serve_run["server"]["launches"][name],
                   "serve_engine": serve_run["engine"]["launches"][name],
                   "compress_moe": moe_run["launches"][name],
                   "compress_moe_capacity": moe_cap_run["launches"][name],
                   **{path: run["launches"][name]
                      for path, run in moe_paths.items()},
                   **{path: run["launches"][name]
                      for path, run in gemma_paths.items()},
                   **{path: run["launches"][name]
                      for path, run in policy_paths.items()},
                   **{path: run["launches"][name]
                      for path, run in kimi_paths.items()},
                   **{path: run["launches"][name]
                      for path, run in ssm_paths.items()},
                   **{path: run["launches"][name]
                      for path, run in mm_paths.items()},
                   **{path: run["launches"][name]
                      for path, run in train_paths.items()},
                   **{path: run["launches"][name]
                      for path, run in zoo_paths.items()}}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": by_path[path],
                "launches_by_path": by_path, "case": head.get("case"),
                **timing(head)}

    kernels = [
        entry("cov_accum", "src/repro_torch/csrc/cov_accum.cu",
              "src/repro/kernels/cov_accum.py:59", cov_rows, "compress"),
        entry("lowrank_matmul", "src/repro_torch/csrc/lowrank_matmul.cu",
              "src/repro/kernels/lowrank_matmul.py:63", low_rows,
              "compress"),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:79", fa_rows,
              "serve_engine"),
        entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
              "src/repro/kernels/flash_decode.py:98", fd_rows,
              "serve_engine"),
        entry("grouped_matmul", "src/repro_torch/csrc/grouped_matmul.cu",
              "src/repro/kernels/grouped_matmul.py:105", gm_rows,
              "compress_moe"),
        entry("cov_accum_banked", "src/repro_torch/csrc/cov_accum.cu",
              "src/repro/kernels/ops.py:182", banked_rows,
              "compress_moe_capacity"),
        # no TPU kernel: the Pallas flash_attention has no backward, and the
        # JAX package's gradient is XLA's of its model-path scan
        entry("flash_attention_bwd",
              "src/repro_torch/csrc/flash_attention_bwd.cu",
              "XLA differentiates src/repro/models/attention.py:31 (the "
              "Pallas kernel src/repro/kernels/flash_attention.py has no "
              "backward)", bwd_rows, "compress"),
    ]
    fb = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    for row in bwd_rows:
        if "ms" in row and row["case"] != fb["case"]:
            fb[row["case"]] = {**timing(row), "kernel_d": row["kernel_d"]}
    fb["plain_backward_cuda_calls"] = PLAIN_BWD["cuda_calls"]
    # cov_accum_banked's second tap (expert d_ff), with the library named
    # and the same triples by the drop-free route (a launch an expert)
    cb = next(k for k in kernels if k["name"] == "cov_accum_banked")
    timed_banked = [r for r in banked_rows if "ms" in r]
    cb["library"] = timed_banked[0]["library"]
    cb["per_bank_cov_accum_ms"] = timed_banked[0]["per_bank_cov_accum_ms"]
    cb["experts_down_in"] = {**timing(timed_banked[1]), "per_bank_cov_accum_ms":
                             timed_banked[1]["per_bank_cov_accum_ms"]}
    # kimi-k2's bank taps (phase 12: E 32, C 1280, n 7168 and 2048)
    cb["kimi"] = [{**timing(r), "per_bank_cov_accum_ms":
                   r["per_bank_cov_accum_ms"]} for r in timed_banked
                  if r.get("case") == "kimi"]
    # cov_accum at kimi-k2's taps (n 7168 and the dense FFN's 18432)
    cv = next(k for k in kernels if k["name"] == "cov_accum")
    cv["kimi"] = [timing(r) for r in cov_rows if "ms" in r
                  and r["shape"][1] in (7168, 18432)]
    # cov_accum at phase 13's taps (n 256, d_inner 8192, the shared FFN's
    # down tap 14336)
    cv["ssm"] = [timing(r) for r in cov_rows if "ms" in r
                 and r["shape"][1] in (256, 8192, 14336)]
    # cov_accum at phase 14's taps (whisper's T 6000 rows at n 512 and
    # 2048, phi-3-vision's d_model 3072)
    cv["multimodal"] = [timing(r) for r in cov_rows if "ms" in r
                        and (r["shape"][0] == 6000 or r["shape"][1] == 3072)]
    # lowrank_matmul's other bodies, where the engine runs them: decode's
    # T 8 (small_t) and the prefill chunk's T 256 (wgmma, split), and its
    # launches on each path by row count
    low = next(k for k in kernels if k["name"] == "lowrank_matmul")
    for key, t_rows in (("decode_T8", 8), ("chunk_T256", 256)):
        low[key] = timing(next(r for r in low_rows if "ms" in r
                               and r["shape"][0] == t_rows
                               and not r["forced"]))
        low[key]["body"] = next(
            r["body"] for r in low_rows if "ms" in r
            and r["shape"][0] == t_rows and not r["forced"])
    low["launches_by_rows"] = {
        "compress": main_run["lowrank_rows"],
        "serve_server": serve_run["server"]["lowrank_rows"],
        "serve_engine": serve_run["engine"]["lowrank_rows"],
        "compress_moe": moe_run["lowrank_rows"],
        "compress_moe_capacity": moe_cap_run["lowrank_rows"],
        **{path: run["lowrank_rows"] for path, run in moe_paths.items()},
        **{path: run["lowrank_rows"] for path, run in gemma_paths.items()},
        **{path: run["lowrank_rows"] for path, run in policy_paths.items()
           if "lowrank_rows" in run},
        **{path: run["lowrank_rows"] for path, run in kimi_paths.items()},
        **{path: run["lowrank_rows"] for path, run in ssm_paths.items()},
        **{path: run["lowrank_rows"] for path, run in mm_paths.items()},
        **{path: run["lowrank_rows"] for path, run in train_paths.items()
           if "lowrank_rows" in run},
        **{path: run["lowrank_rows"] for path, run in zoo_paths.items()}}
    # kimi-k2's eight factorized shapes at each T (phase 12)
    kimi_shapes = [list(s) for s in SIZES["lowrank_nkm_kimi"]]
    low["kimi"] = [{**timing(r), "body": r.get("body")} for r in low_rows
                   if "ms" in r and not r.get("forced")
                   and list(r["shape"][1:]) in kimi_shapes]
    # phase 13's nine factorized shapes (zamba2, falcon-mamba) at each T
    ssm_shapes = [list(nkm) for nkm, _ in SIZES["lowrank_nkm_ssm"]]
    low["ssm"] = [{**timing(r), "body": r.get("body")} for r in low_rows
                  if "ms" in r and not r.get("forced")
                  and list(r["shape"][1:]) in ssm_shapes]
    # grouped_matmul at decode's 48 rows (the dense bank and the factorized
    # x @ V), at an engine chunk's 1536 (x @ V), and one bf16 backward (dx
    # and dW) at the x @ V shape
    gm = next(k for k in kernels if k["name"] == "grouped_matmul")
    for key, case in (("decode_M48", "decode"), ("decode_v_M48", "decode_v"),
                      ("chunk_v_M1536", "chunk_v")):
        gm[key] = timing(next(r for r in gm_rows if "ms" in r
                              and r["case"] == case))
    back = next(r for r in gm_back if "ms" in r)
    gm["backward_x_v"] = {**timing(back), **{
        key: back[key] for key in ("dx_ms", "library_dx_ms",
                                   "library_dw_ms", "library_dw_note",
                                   "library_dw_rel_err") if key in back}}
    # its launches on the serving paths by routed row count (decode: 8
    # slots x top-6 = 48 rows)
    gm["launches_by_rows"] = {path: run["grouped_rows"]
                              for path, run in moe_paths.items()}
    # MLA prefill's head dim (the instance phase 7 runs), the chunk, and
    # the split body at decode (dense-cache serving), with the launches of
    # each body on each path
    fa = next(k for k in kernels if k["name"] == "flash_attention")
    for key, case in (("mla_prefill_d192", "mla_prefill"),
                      ("mla_server_d192", "mla_server"),
                      ("chunk_Lq256", "chunk"), ("decode_split", "decode"),
                      ("gemma_local_d256", "gemma_local"),
                      ("gemma_global_d256", "gemma_global"),
                      ("gemma_server_d256", "gemma_server"),
                      ("gemma_decode_split_d256", "gemma_decode"),
                      ("kimi_prefill_d112", "kimi_prefill"),
                      ("kimi_decode_split_d112", "kimi_decode"),
                      ("zamba2_prefill_d112", "zamba2_prefill"),
                      ("zamba2_decode_split_d112", "zamba2_decode"),
                      ("whisper_encoder_noncausal", "whisper_encoder"),
                      ("whisper_cross_noncausal", "whisper_cross"),
                      ("whisper_cross_decode_split", "whisper_cross_decode"),
                      ("whisper_decoder_causal", "whisper_decoder"),
                      ("vision_prefill_d96", "vision_prefill"),
                      ("vision_decode_split_d96", "vision_decode")):
        row = next(r for r in fa_rows if r["case"] == case and "ms" in r)
        fa[key] = {**timing(row), "kernel_d": row["kernel_d"]}
    # flash_decode: its kernels by body, the fp32 row (phase 6 (c)'s fp32
    # route and phase 4's smoke serving take the FMA body), and the
    # engine's launches by keys body
    fdk = next(k for k in kernels if k["name"] == "flash_decode")
    fdk["bodies"] = {"wgmma": ["fdec_split_u", "fdec_keys_wgmma<D>",
                               "fdec_values<T>", "fdec_merge",
                               "fdec_out<T, D>"],
                     "fma": ["fdec_keys_fma<T, D>", "fdec_values<T>",
                             "fdec_merge", "fdec_out<T, D>"]}
    fdk["fp32"] = timing(next(r for r in fd_rows if "ms" in r
                              and r["dtype"] == "float32"))
    # granite-3-8b's full-width GQA decode (32 query heads on 8 KV heads)
    fdk["granite_gqa"] = timing(next(r for r in fd_rows if "ms" in r
                                     and r["case"] == "granite"
                                     and r["dtype"] == "bfloat16"))
    # kimi-k2's head dim 112 (64 query heads on 8 KV heads, rank 480):
    # the wgmma body in bf16, the FMA body in fp32
    for key, dt in (("kimi_d112", "bfloat16"), ("kimi_d112_fp32", "float32")):
        fdk[key] = timing(next(r for r in fd_rows if "ms" in r
                               and r["case"] == "kimi" and r["dtype"] == dt))
    # zamba2's shared block: head dim 112, one query head a KV head (32 on
    # 32), rank 1080
    for key, dt in (("zamba2_d112_g1", "bfloat16"),
                    ("zamba2_d112_g1_fp32", "float32")):
        fdk[key] = timing(next(r for r in fd_rows if "ms" in r
                               and r["case"] == "zamba2"
                               and r["dtype"] == dt))
    # whisper's decoder (D 64 without RoPE, rank 160) and phi-3-vision (D
    # 96, rank 928): the wgmma body in bf16, the FMA body in fp32
    for key, case, dt in (("whisper_d64_norope", "whisper", "bfloat16"),
                          ("whisper_d64_norope_fp32", "whisper", "float32"),
                          ("vision_d96", "vision", "bfloat16"),
                          ("vision_d96_fp32", "vision", "float32")):
        fdk[key] = timing(next(r for r in fd_rows if "ms" in r
                               and r["case"] == case and r["dtype"] == dt))
    fdk["launches_by_body"] = {
        "serve_engine": serve_run["engine"]["decode_bodies"],
        "serve_ckpt_engine": policies["engine"]["decode_bodies"],
        "serve_kimi_engine": kimi["engine"]["decode_bodies"],
        "serve_zamba2_engine": zamba2["engine"]["decode_bodies"],
        "serve_whisper_engine": whisper["engine"]["decode_bodies"],
        "serve_vision_engine": vision["engine"]["decode_bodies"]}
    fa["launches_by_body"] = {
        "compress": main_run["flash_bodies"],
        "serve_server": serve_run["server"]["flash_bodies"],
        "serve_engine": serve_run["engine"]["flash_bodies"],
        "serve_engine_dense": serve_run["engine_dense"]["flash_bodies"],
        "compress_moe": moe_run["flash_bodies"],
        "compress_moe_capacity": moe_cap_run["flash_bodies"],
        **{path: run["flash_bodies"] for path, run in moe_paths.items()},
        **{path: run["flash_bodies"] for path, run in gemma_paths.items()},
        **{path: run["flash_bodies"] for path, run in kimi_paths.items()},
        **{path: run["flash_bodies"] for path, run in ssm_paths.items()},
        **{path: run["flash_bodies"] for path, run in mm_paths.items()},
        **{path: run["flash_bodies"] for path, run in train_paths.items()},
        **{path: run["flash_bodies"] for path, run in zoo_paths.items()}}
    # flash_attention at qwen3-0.6b's training shape (phase 15 (e)): the
    # forward kernel beside the plain backward and SDPA's forward and
    # forward + backward, with its launches in one train step by body
    ta = trainer["attention"]
    fa["qwen3_train"] = {
        **timing(ta), "kernel_d": ta["kernel_d"],
        **{key: ta[key] for key in ("plain_backward_ms",
                                    "library_causal_fwd_bwd_ms",
                                    "bound_fwd_bwd_ms", "bound_fwd_bwd_by")},
        "backward_kernel_device_ms": ta["backward_kernel_device_ms"],
        "launches_per_step": trainer["run"]["flash_bodies_per_step"]}
    # the backward at the training shape: the kernel beside the plain
    # backward, SDPA's forward + backward and the backward's bound, its
    # launches in one train step and one step's device split
    fb["qwen3_train"] = {
        **timing(ta["backward_row"]), "kernel_d": ta["backward_row"]
        ["kernel_d"], "library_causal_fwd_bwd_ms":
        ta["library_causal_fwd_bwd_ms"], "library_causal_fwd_bwd_device_ms":
        ta["library_causal_fwd_bwd_device_ms"],
        "launches_per_step": trainer["run"]["launches_per_step"]
        ["flash_attention_bwd"],
        "train_step_split_ms": trainer["run"].get("split", {}).get(
            "flash_attention_bwd_ms")}
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "cov_accum": cov_rows,
                   "cov_accum_banked": banked_rows,
                   "lowrank_matmul": low_rows, "flash_attention": fa_rows,
                   "flash_attention_checks": fa_checks,
                   "flash_decode": fd_rows, "flash_decode_checks": fd_checks,
                   "grouped_matmul": gm_rows,
                   "grouped_matmul_backward": gm_back, "smoke": smoke,
                   "main": main_run, "serve": serve_run, "moe": moe_run,
                   "moe_capacity": moe_cap_run, "serve_moe": serve_moe,
                   "gemma": gemma, "policies": policies,
                   "policies_moe": policies_moe, "kimi": kimi,
                   "zamba2": zamba2, "falcon": falcon, "whisper": whisper,
                   "vision": vision, "train": trainer, "zoo": zoo,
                   "autotune": tuned, "tuner_by_phase": TUNER_BY_PHASE,
                   "kernels": kernels}, f, indent=1)
    log(f"whole run: {time.perf_counter() - t_run:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    # the card's line again, inside the tail a caller may keep of the output
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
