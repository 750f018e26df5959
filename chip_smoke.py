"""Smoke test of the PyTorch/CUDA port (lmdeploy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py       # needs one CUDA card

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   -- card name, power limit and count;
  2. build    -- nvcc builds every kernel of the port from csrc/ (one process per source),
                 with each kernel's registers and spills, for the wgmma kernels the
                 HGMMAs that wait for the one before, and for the int4 / TurboQuant
                 decodes the HMMAs that take the one before as accumulator (SASS);
  3. kernels  -- each kernel against its plain PyTorch version on the card, at the
                 main paths' shapes, with its time, the plain version's time, the
                 card's bound for the same work and, where one PyTorch call computes
                 the same function, that call's time: flash_prefill, paged_decode
                 (also at gpt-oss-20b heads with sinks, window 128 and none),
                 paged_decode_int8 (caches filled by the port's fill_kv_cache, random
                 stale slots past every row; llama2-7b and TinyLlama heads, the
                 e2e_w4a16_kv8 decode shape, f16 D 256, D 192, f32 q and D 80; its
                 split length swept, the plain two passes and their combine trap held) and
                 w4a16_gemm (llama2-7b projections at M 1 / 8 / 64 / 65 / 128 / 256
                 and Mixtral-8x7B's fused wqkv at 64, TF32 off, every K split at the
                 64- and 128-row shapes, each row's token tile and split; the check
                 must catch each planted numerical trap) and
                 mxfp4_bmm (gpt-oss-20b gate and down products at M 8 / 37 / 64 / 128 /
                 767 and at K 192, each row's token tile; every code times edge
                 scales, exactly; the check must catch each planted trap, the last
                 half-stage read from the next expert included) and the KV policies'
                 decodes paged_decode_int4, paged_decode_turbo and paged_decode_fp8
                 (caches filled by the port's fill; the e2e_llama31 decode shape,
                 llama2-7b and TinyLlama heads; planted traps in the cache bytes; the
                 int4 and TurboQuant rows also at f16 D 256, f32 q, int4 D 192 / 80,
                 the e4m3 rows at f16 / f32 q, gpt-oss heads with sinks and window,
                 block sizes 16 and 8; each with its split length swept and the plain
                 two passes held, a trap planted in their combine); paged_decode's
                 narrow rows also hold their split's plain two passes and combine
                 trap, a window that covers whole splits, rows shorter than one split
                 and block sizes 8 and 16; paged_decode_int8 / _int4 / _turbo over
                 caches of block size 8 and 2, on their own and through paged_attention
                 (the kernel route and its one launch asserted), and an Engine at block
                 size 8 for each (greedy tokens equal to block size 16's);
                 w4a16_szc (fast / precise) and w4a16_unprepared (raw scales and zeros)
                 at Mixtral-8x7B's and llama2-7b's projections, M 1 to 256, each with
                 its planted traps and every K split; fp8_bmm (DeepSeek-V2-Lite's gate and down products at
                 M 8 / 37 / 64 / 128 / 767 and V3's at 64, each row's token tile and
                 work items; the check must catch each planted trap; also at scale
                 groups 16-256, those that straddle its 128-row K stages included, and
                 every e4m3 code times edge scales, exactly); flash_prefill and
                 paged_decode also at MLA's latent head (one kv
                 head of 576 under 16 and 128 query heads) and at D 80 / 96 / 192 / 256,
                 in f16 and f32; paged_decode_cp (the context-parallel partials of each
                 rank, the ranks on the one card, and their combine) at the
                 e2e_llama31_8b_cp2 decode shape with cp 2 and 4, gpt-oss-20b heads with
                 sinks and window 128 or none, D 64 / 96 / 256 in f16 and f32, beside the
                 single-rank paged_decode at each shape, with its planted traps, the
                 partials' and the combine's times apart, each rank's split in plain
                 PyTorch, the partials of ranks with no slot in a row's window (exactly
                 (0, MASK_VALUE, 0)), and its split length swept at the e2e shapes; and
                 paged_decode_int8 / _int4 at MLA's latent head (16 and 128 query heads);
  4. parity   -- full width, 2 layers: prefill logits and 8 decode steps on the card
                 (bf16, kernels) against the port on the CPU (f32, plain paths), for
                 TinyLlama bf16, for llama2-7b W4A16 with an int8 KV cache and for
                 gpt-oss-20b with MXFP4 experts (one sliding, one full layer; the CPU
                 runs the experts widened to f32, and the routing flips between the two
                 sides are counted), and for Llama-3.1-8B with the int4, TurboQuant and
                 fp8 KV caches and with a bf16 KV striped over cp 2 (both sides), and for
                 Mixtral-8x7B W4A16 under the gd and precise schedules (the CPU runs
                 the experts widened to f32; fast and unprepared: kernel rows), and for
                 DeepSeek-V2-Lite with blocked-fp8 experts (the dense
                 layer and one MoE layer) with the bf16, int8 and int4 MLA caches;
                 beside it the bf16 floor (plain versions on
                 the card) and what each planted trap reads, which must exceed the
                 allowance;
  5. e2e      -- the port's Engine at TinyLlama-1.1B width and depth (random seeded
                 bf16 weights): 8 concurrent 128-token prompts plus one 2048-token
                 prompt, 64 greedy tokens each, run twice; every kernel's launch count
                 is read from the first run (the narrow decode's combines too); then
                 a traced run (device busy share).  In every e2e phase the engine
                 decodes by replaying CUDA graphs: ModelAgent.warmup captures the
                 cell's batch bucket first (graphs, capture seconds and pool bytes
                 printed), a graph's launches are counted at its capture times its
                 replays, and a decode run that does not replay fails the phase; the
                 trace counts graph launches and the host's waits for the card;
     decode_graphs -- after the e2e, e2e_w4a16_kv8 and e2e_llama31_8b_cp2 phases: the
                 same requests on an engine of the same weights with eager_mode=True,
                 in turns with the graph engine (greedy: eager, graphs; every other
                 request seeded-sampled: graphs, eager), then one traced eager run;
                 greedy and sampled tokens must be equal between the modes; each
                 mode's decode tok/s, TTFT p50 and busy share;
  6. e2e_w4a16_kv8 -- the same at llama2-7b geometry (4 of its 32 layers, LW4),
                 AWQ-style W4A16 weights (group 128, seeded) and quant_policy=4: 64 concurrent 128-token prompts plus
                 one 2048-token prompt, 64 greedy tokens each, run twice, then traced;
                 each decode step launches paged_decode_int8 (and its split's combine)
                 once a layer, exactly;
  7. e2e_gptoss_mxfp4 -- gpt-oss-20b at full width and 4 of its 24 layers (public
                 config), seeded MXFP4 experts, bf16 KV cache: 32 concurrent 128-token prompts plus one
                 2048-token prompt, 64 greedy tokens each (decode in the 64-row bucket),
                 run twice, then traced; the rows of every mxfp4_bmm launch are recorded;
  8. e2e_llama31_8b_kv4 / _turbo / _fp8kv -- Llama-3.1-8B at full width and 4 of its
                 32 layers (public config, seeded bf16 weights built once for the three)
                 with quant_policy 8, 42 and 16: 63 concurrent 1024-token prompts plus
                 one 4096-token prompt, 64 greedy tokens each, run twice, then traced;
                 each decode step launches the policy's kernel once a layer (int4 and
                 TurboQuant: each with its split's combine), each prefill step whose
                 chunks all start their prompts flash_prefill once a layer, exactly; e2e_llama31_8b_cp2 -- the same weights with bf16 KV
                 striped over 2 context-parallel ranks on the one card: 31 concurrent
                 1024-token prompts and one 16,384-token prompt, 64 greedy tokens each,
                 run twice, then traced; each decode step launches paged_decode_cp twice
                 a layer and paged_decode never, exactly;
  9. e2e_mixtral8x7b_w4a16 (+ _fast / _precise / _unprepared) -- Mixtral-8x7B at full
                 width and 2 of its 32 layers (LMIX; public config, seeded AWQ-form W4A16
                 weights, ~1.6 GB, built once for the four), bf16 KV: 63 concurrent 256-token prompts plus
                 one 2048-token prompt (one 64-row wave, as the Llama-3.1-8B cells);
                 under gd 64 greedy tokens each, run twice, then
                 traced; under the other three schedules one run of 16 tokens.  Each
                 decode step (and prefill step of at most 256 rows) launches the
                 schedule's W4A16 kernel twice a layer and no other W4A16 kernel, exactly;
 10. e2e_deepseek_v2_lite_fp8 -- DeepSeek-V2-Lite at full width and 4 of its 27
                 layers (LDS; public config, 1 dense and 3 MoE layers, seeded blocked-fp8
                 routed experts), bf16 MLA cache: 63 concurrent 1024-token prompts plus
                 one 4096-token prompt, 64 greedy tokens each, run twice, then traced;
                 each decode step launches fp8_bmm 9 times and paged_decode 4 times,
                 each fresh prefill step flash_prefill 4 times, exactly;
 11. int_mm   -- (after the kernel rows) the W8A8 product's int8 route, torch._int_mm with
                 its rows padded to cuBLASLt's 17, bit-exact against an f64 product of the
                 same codes at M 1 / 16 / 17 / 64 / 2048, eagerly and from a captured
                 graph; the fp8 weight-only product's f32-output GEMM; the three 8-bit
                 products' times at M 64 beside the dense bf16 GEMM's; routing_ties --
                 sparsemixer's choices and weights on the card equal to the CPU's on rows
                 with tied maxima and scores at the jitter threshold;
 12. parity_llama31_8b_w8a8 / _fp8, parity_qwen3_8b_fp8, parity_phimoe,
     parity_glm45_air, parity_deepseek_moe_16b -- the parity phase (4) for
                 Llama-3.1-8B in SmoothQuant W8A8 and fp8 weight-only (per-channel) form,
                 Qwen3-8B-FP8 (blocked 128 x 128), Phi-3.5-MoE, GLM-4.5-Air and
                 DeepSeek-MoE 16B (their public configs, 2 layers: the dense layer and one
                 MoE layer where the model has both), each with a planted trap;
 13. e2e_llama31_8b_w8a8 / _fp8, e2e_qwen3_8b_fp8, e2e_phimoe, e2e_glm45_air,
     e2e_deepseek_moe_16b -- the same six at full width and 4 layers: 63 concurrent
                 256-token prompts plus one of 2048 (4096 for Phi-3.5-MoE, whose long
                 rope table then serves), 32 greedy tokens each, one run (each fresh
                 prefill step launches flash_prefill and each decode step paged_decode
                 once a layer, exactly), traced, then one run on an eager_mode engine of
                 the same weights whose greedy tokens must be equal;
 14. parity_gemma2_9b / _glm4_9b / _starcoder2_7b, then e2e_ of the same names -- the
                 dense variants' public configs, 2 layers (random norms and biases;
                 Gemma-2's wq and embedding scaled so that its softcaps engage) with
                 their traps (softcaps and Gemma's +1 left out, GLM's rope in rotate-half
                 order, its sandwich norms left out, StarCoder2's LayerNorm without its
                 bias), then 4 layers to 63 x 256 + one prompt of 6,144 / 2,048 / 6,144
                 tokens, 32 greedy tokens, two runs, traced, then decode_graphs' greedy
                 pair: one paged_decode a layer per decode step, and flash_prefill a
                 layer per fresh prefill step on GLM-4 only (a softcap or a window sends
                 Gemma-2's and StarCoder2's prefill to the gathered path);
 15. spec     -- speculative decoding over Llama-3.1-8B at full width and L31 layers
                 (seeded bf16 weights shared by every engine), K = 4: reject_sample and
                 the row advance on the card equal to the CPU's with planted
                 distributions and uniforms (spec_sampler); the verify's logits (the
                 gathered path) against K+1 decode steps (row 2) from the same cache
                 (spec_verify_vs_decode); the EAGLE-1 and EAGLE-3 head steps at their
                 published widths, bf16 on the card against f32 on the CPU
                 (spec_head_step); the plain engine on the cells' traffic (63 x 256 +
                 one 2,048-token prompt, 32 tokens, greedy with top-2 logprobs); then the
                 cells spec_eagle3 (yuhuili/EAGLE3-LLaMA3.1-Instruct-8B's head),
                 spec_draft_llama32_1b (Llama-3.2-1B as the draft) and spec_self_draft
                 (the target's own weights as the draft), each on a graph engine (every
                 step replays its graph and launches paged_decode K x draft layers
                 times and flash_prefill none) and an eager_mode engine (tokens equal,
                 two seeded-sampled rows and one host-driven logprobs row included); the
                 greedy tokens equal the plain engine's but where its top-2 margin lies
                 below the verify allowance; each cell's decode tok/s, tokens emitted a
                 step, TTFT, graphs and busy share.
 16. mtp_dsa  -- DeepSeek-V3's and GLM-4.5-Air's MTP head steps at full width in bf16
                 against f32 (mtp_step, on the f32 step's expert choices); V3.2's first
                 two layers over one 4,096-token prompt, bf16 against f32 on the card:
                 logits and the indexer's top-2,048 picks, with its rope order, the
                 Hadamard of its keys and its ties planted as traps
                 (parity_deepseek_v32, and parity_glm_moe_dsa_v32_widths for the
                 GLM-MoE-DSA path); DeepSeek-V3 at 4 layers plus its MTP layer with
                 deepseek_mtp (spec_mtp_deepseek_v3: the speculative cells' traffic;
                 paged_decode K times and fp8_bmm 3 times a dense-combine chunk
                 a step, exactly); DeepSeek-V3.2 at 4 layers (e2e_deepseek_v32_fp8: 24 x
                 1,024 + 8 x 4,096 tokens, 32 greedy tokens; fp8_bmm 3 times a decode
                 step, no attention kernel); each cell against an eager_mode engine.
 17. qwen3_next -- Qwen3-Next-80B-A3B at full width and QN_LAYERS = 4 of its 48 layers
                 (3 gated-DeltaNet, 1 gated full attention; seeded bf16, 512 experts):
                 parity_qwen3_next (a 4,096-token and a 3,000-token prompt in one chunk,
                 8 decode steps, bf16 with the kernels against f32 on the card on the f32
                 run's expert choices; the floor and four planted traps: norms without
                 +1, in_proj_qkvz split as quarters, the conv state from padded
                 positions, the rope over all 256 dims) and parity_qwen3_5_moe_widths
                 (the same network in Qwen3.5-MoE's split layout, with a trap); then
                 e2e_qwen3_next_80b_a3b (63 x 256 + one 4,096-token prompt, 32 greedy
                 tokens, one run: exactly one flash_prefill a fresh prefill step and one
                 paged_decode a decode step, every decode run a graph replay;
                 hybrid_state_check: every live slot's conv and rec state bit-equal under
                 a scratch pass and an inactive replay, and the gated-delta ops' share of
                 device time from a trace), traced, then an eager_mode engine (tokens
                 equal).  The kernel rows hold rows 1-2 at its heads (Hq 16, Hkv 2, D 256).
 18. e2e_llama31_8b_guided_slora -- (after the Llama-3.1-8B CP cell, on its seeded
                 weights; L31 layers, bf16 KV, block size 128, 64 rows, graphs) a seeded
                 vocabulary of 128,256 strings in place of the tokenizer; one batch of 24
                 greedy guided rows (json_object, json_schema, regex_schema), 8 sampled
                 json_object rows (top-k 40), 8 bad-words rows (16 banned ids) and 24
                 plain rows, 32 tokens, twice: with the speculative grammar acceptance and
                 with LMDEPLOY_TPU_GUIDED_SPEC=0; every guided output legal, greedy
                 guided tokens equal between the runs but where the masked top-2 margin
                 lies below GUIDED_MARGIN_TOL, no banned id, no host step for a plain row,
                 every decode run a replay; recoveries, rejections, the acceptance EMA,
                 host ms per distinct mask and cache hits.  S-LoRA: two seeded adapters
                 (ranks 8 / 16, all seven targets) in one batch with rows of no adapter;
                 the engine's KV cache sized at the default fraction after its stacks;
                 logits at 4 decode steps within SLORA_LOGIT_TOL of f32 on the merged
                 weights (the adapter left out must read past it); no-adapter rows
                 against a base engine of the same leaves, adapter rows against it after
                 activate_lora (the graphs captured before replaying the merge), and again
                 after deactivate_lora, each under the margin rule; each engine's own
                 top-2 logprobs within SLORA_LP_TOL of f32 on its rows' weights fed its
                 tokens, and past it for the traps (rows served with the adapter left
                 out, or added where there is none).  flash_prefill and paged_decode
                 launch exactly once a layer of each fresh prefill and decode step.
  logits_ppl_reward -- scoring without generation, through AsyncEngine (from_engine):
                 Llama-3.1-8B at L31 layers on the same weights (before the guided cell
                 writes into them), session 10,240: async_get_ppl over 16 seeded texts
                 of 256-2,048 ids and one of 10,000 (8,192 fresh, then 1,808 over the
                 cache), async_get_logits over three of them; every per-position NLL and
                 the logits within NLL_TOL / LOGITS_TOL of f32 on the same weights (one
                 pass over each whole text, plain versions), with three planted traps
                 (the second chunk's positions restarted, its history ignored, the NLL
                 against unshifted targets) past them; exactly one flash_prefill a
                 layer of each text's first chunk and no other launch; 64 greedy
                 128-token requests on graphs, alone and with the 17 ppl requests
                 issued while they decode: tokens and ppl equal bit for bit.  Then
                 Qwen2.5-Math-RM-72B and internlm2-7b-reward (2 layers, seeded):
                 async_get_reward_score over 16 prompts of 64-2,048 ids within
                 REWARD_TOL of f32 relative to the scores' spread, traps past it (ReLU
                 left out, the first position's score; h unrounded reported).
Parity rows and depths cut for the script's time are listed in PERF.md section 4.
The line before the last lists every kernel; the last line is the result.
It imports nothing of jax or lmdeploy_tpu.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data sheet (dense): bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|, per kernel.  Both
# sides accumulate in f32 and write bf16, so they may differ by one bf16 ulp (2^-8 to
# 2^-7 of |ref|): paged_decode allows just that.  flash_prefill also rounds P to bf16
# for the P.V product, as the TPU kernel does (_flash_kernel's p.astype(v.dtype)),
# where the plain version keeps P in f32: its outputs (|ref| up to ~2) differ by up
# to two ulps, and the allowance is 1e-2 absolute on top
# paged_decode_int8 is held like paged_decode (both sides f32, one bf16 rounding).
# w4a16_gemm: both sides sum exact bf16 x bf16 products in f32 with the same f32
# scales and correction, in another order, and round once to bf16; the cancelling
# +128 bias term is ~50x the outputs (~1), so the f32 order adds ~1e-5 to one bf16 ulp
# mxfp4_bmm: both sides multiply the same bf16 operands (x rounded, e2m1 * 2^k exact)
# and write f32; only the order of the K = 2880 f32 additions differs (terms up to
# ~0.2, outputs ~1-10), and the tensor cores' f32 accumulation may truncate on
# alignment.  The first card run read at most 1.6e-5 (H100 80GB HBM3, 700 W);
# the allowance is 1e-4 + 1e-4 |ref|
# fp8_bmm is held like mxfp4_bmm: both sides multiply the same bf16 operands (x
# rounded, each weight bf16(decode(w8) * scale)) and write f32, in another order of
# the K f32 additions (terms ~0.02, outputs ~1 on the seeded stacks)
# paged_decode_int4, _turbo and _fp8 are held like paged_decode (both sides f32, one
# bf16 rounding), and so is paged_decode_cp: each rank's partials in f32 on both sides,
# the same f32 combine, one rounding of the output
# w4a16_szc and w4a16_unprepared are held like w4a16_gemm: both sides take the same
# bf16 operands (fast / precise: the same bf16 products of each weight with its scale)
# and the same correction, sum in f32 in another order, and round once to bf16
KERNEL_TOL = {'flash_prefill': {'atol': 1e-2, 'rtol': 1e-2},
              'paged_decode': {'atol': 1e-3, 'rtol': 1e-2},
              'paged_decode_int8': {'atol': 1e-3, 'rtol': 1e-2},
              'paged_decode_int4': {'atol': 1e-3, 'rtol': 1e-2},
              'paged_decode_turbo': {'atol': 1e-3, 'rtol': 1e-2},
              'paged_decode_fp8': {'atol': 1e-3, 'rtol': 1e-2},
              'w4a16_gemm': {'atol': 2e-3, 'rtol': 1e-2},
              'w4a16_szc': {'atol': 2e-3, 'rtol': 1e-2},
              'w4a16_unprepared': {'atol': 2e-3, 'rtol': 1e-2},
              'mxfp4_bmm': {'atol': 1e-4, 'rtol': 1e-4},
              'fp8_bmm': {'atol': 1e-4, 'rtol': 1e-4},
              'paged_decode_cp': {'atol': 1e-3, 'rtol': 1e-2}}
LOGIT_TOL = 0.1          # bf16 activations through 2 full-width layers vs f32
# llama2-7b width, W4A16 + int8 KV: logits reach ~6 (TinyLlama's ~4), and bf16
# activations alone move them more at this width.  The phase reads (H100 80GB HBM3,
# 700 W): 0.1553 with every kernel swapped for its plain version (bf16 alone), 0.1545
# with the kernels; with a W4A16 trap planted in the decode steps' group-dot, 0.2407
# (TF32 correction), 1.78 and 1.94 (the other two).  The allowance sits midway
# between the bf16 floor and the mildest trap
LOGIT_TOL_W4 = 0.2
# gpt-oss-20b width, MXFP4 experts, 2 layers, the card's runs on the CPU's expert
# choices: logits reach ~5.  The phase read (H100 80GB HBM3, 700 W) 0.1157 with every
# kernel swapped for its plain version, 0.1215 with the kernels; with a trap planted in
# every MXFP4 product, 3.054 (high half with the low half's scales) and 5.067 (code 9
# read as +0.5).  The traps lie 26-44x above the floor, so the allowance is set from
# the floor's side, about 2.5x it: a kernel slip worth a few tenths of a logit fails
LOGIT_TOL_GPTOSS = 0.3
# Llama-3.1-8B width, 2 layers, per KV policy, held on the 8 decode steps (the card's
# prefill attends the chunk's exact K/V through flash_prefill, the CPU's the quantized
# cache, as in the reference: their prefill logits differ by the quantization error
# itself, 1.78 int4 / 3.68 TurboQuant / 0.53 fp8).  Logits reach ~6.  The phase read
# (H100 80GB HBM3, 700 W), floor (plain versions on the card) / kernels / traps:
# int4 0.878 / 0.841 / 8.92 (nibble order swapped), 9.68 (min terms dropped);
# TurboQuant 1.129 / 1.145 / 2.95 (QJL term dropped), 8.37 (V codebook magnitudes
# swapped); fp8 0.409 / 0.400 / 6.94 (bytes read as e5m2).  Each allowance is about
# twice its floor (TurboQuant's midway to its mildest trap)
LOGIT_TOL_KV = {8: 1.8, 42: 2.0, 16: 0.8}
KV_PHASE = {8: 'kv4', 42: 'turbo', 16: 'fp8kv'}
# Mixtral-8x7B W4A16, 2 layers, per W4A16 schedule, the card on the CPU's expert
# choices: logits reach ~5.2-5.7.  The phase read (H100 80GB HBM3, 700 W) floor (plain
# versions on the card) / kernels / held traps: gd 0.119 / 0.107 / 0.219 (TF32
# correction), 1.36, 2.40; fast 0.109 / 0.118 / 0.344 (TF32 correction), 2.48 (corr
# from unrounded scales), 1.45 (scale on the dot outputs); precise 0.122 / 0.115 / 8.23
# (subtrahend 128; its scale on the dot outputs reads 0.121, within the floor, and is
# reported only); unprepared as gd (the same arithmetic) / 8.22 (zeros ignored), 8.41
# (planes swapped).  One allowance sits between every floor and the mildest trap.  For
# the script's time the gd and precise rows run (precise's products at model level, its
# scale on the dot outputs reported); fast and unprepared hold their traps in their
# kernel rows (SZC_TRAPS, UNPREP_TRAPS) and their e2e cells still serve
LOGIT_TOL_MIXTRAL = {'gd': 0.17, 'precise': 0.17}
# DeepSeek-V2-Lite, 2 layers (the dense one and one MoE layer), blocked-fp8 experts, the
# card on the CPU's expert choices: logits reach ~4.3.  The phase read (H100 80GB HBM3,
# 700 W) 0.0440 with every kernel swapped for its plain version, 0.0467 with the
# kernels; held traps 4.79 (rope dims not de-interleaved) and 0.218 (each group read
# with the next group's scale row); the two reported ones about the floor (x unrounded
# 0.0466, V plane not zero-padded 0.0467, which is held on the attention output's rope
# columns instead).  The allowance is about twice the floor, below half the mildest
# held trap
LOGIT_TOL_DEEPSEEK = 0.1
# Llama-3.1-8B, 2 layers, bf16 KV striped over cp 2 on both sides (the card's ranks on
# the one card, the CPU's on the CPU), prefill and decode held: logits reach ~6.1.  The
# phase read (H100 80GB HBM3, 700 W) 0.1076 with every kernel swapped for its plain
# version, 0.1028 with the kernels; the combine without its weights 5.56, a rank
# reading its slots at rank 0's positions 1.20 (0.099 while the unfilled slots were
# zero: the caches now start from stale random pages).  The allowance is about twice
# the floor
LOGIT_TOL_CP = 0.2
# DeepSeek-V2-Lite as above with the int8 (quant_policy 4) and int4 (8) MLA caches.
# int8 holds prefill and decode (as parity_w4a16_kv8: the card's prefill attends the
# exact latents through flash_prefill, the CPU's the int8 cache, which moves the
# logits by less than the bf16 floor); the phase read (H100 80GB HBM3, 700 W) floor
# 0.0772, kernels 0.0767, held traps 4.80 (rope) and 0.224 (next group's scale row):
# the allowance sits between.  int4 holds the decode steps (its prefill logits differ
# by the int4 error itself, 0.84, as the Llama-3.1-8B KV policies'): floor 0.378,
# kernels 0.380, held traps 4.84 (rope), 6.00 (nibble order swapped), 6.45 (min terms
# dropped); the allowance is about 2.6x its floor
LOGIT_TOL_DEEPSEEK_KV = {4: 0.15, 8: 1.0}
SEED = 1234
# the public config.json of openai/gpt-oss-20b (its fields the port reads)
GPT_OSS_20B = {
    'architectures': ['GptOssForCausalLM'], 'model_type': 'gpt_oss',
    'hidden_size': 2880, 'intermediate_size': 2880, 'num_hidden_layers': 24,
    'num_attention_heads': 64, 'num_key_value_heads': 8, 'head_dim': 64,
    'num_local_experts': 32, 'num_experts_per_tok': 4, 'experts_per_token': 4,
    'vocab_size': 201088, 'max_position_embeddings': 131072, 'initial_context_length': 4096,
    'rms_norm_eps': 1e-05, 'rope_theta': 150000, 'sliding_window': 128,
    'rope_scaling': {'beta_fast': 32.0, 'beta_slow': 1.0, 'factor': 32.0,
                     'original_max_position_embeddings': 4096, 'rope_type': 'yarn',
                     'truncate': False},
    'layer_types': ['sliding_attention', 'full_attention'] * 12,
    'swiglu_limit': 7.0, 'attention_bias': True, 'tie_word_embeddings': False,
    'eos_token_id': 200002, 'pad_token_id': 199999, 'torch_dtype': 'bfloat16',
    'quantization_config': {'quant_method': 'mxfp4', 'modules_to_not_convert': [
        'model.layers.*.self_attn', 'model.layers.*.mlp.router', 'model.embed_tokens',
        'lm_head']},
}

# the public config.json of meta-llama/Llama-3.1-8B-Instruct (its fields the port reads)
LLAMA31_8B = {
    'architectures': ['LlamaForCausalLM'], 'model_type': 'llama',
    'hidden_size': 4096, 'intermediate_size': 14336, 'num_hidden_layers': 32,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'head_dim': 128,
    'vocab_size': 128256, 'max_position_embeddings': 131072, 'rms_norm_eps': 1e-05,
    'rope_theta': 500000.0,
    'rope_scaling': {'factor': 8.0, 'low_freq_factor': 1.0, 'high_freq_factor': 4.0,
                     'original_max_position_embeddings': 8192, 'rope_type': 'llama3'},
    'tie_word_embeddings': False, 'attention_bias': False, 'bos_token_id': 128000,
    'eos_token_id': [128001, 128008, 128009], 'torch_dtype': 'bfloat16',
}


# the public config.json of mistralai/Mixtral-8x7B-Instruct-v0.1 (its fields the port
# reads), with the quantization_config of its AWQ release (4 bits, group 128, zero
# points; the GEMM packing the port's loader reads)
MIXTRAL_8X7B = {
    'architectures': ['MixtralForCausalLM'], 'model_type': 'mixtral',
    'hidden_size': 4096, 'intermediate_size': 14336, 'num_hidden_layers': 32,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'num_local_experts': 8,
    'num_experts_per_tok': 2, 'vocab_size': 32000, 'max_position_embeddings': 32768,
    'rms_norm_eps': 1e-05, 'rope_theta': 1e6, 'sliding_window': None,
    'tie_word_embeddings': False, 'bos_token_id': 1, 'eos_token_id': 2,
    'torch_dtype': 'bfloat16',
    'quantization_config': {'quant_method': 'awq', 'bits': 4, 'group_size': 128,
                            'zero_point': True, 'version': 'gemm'},
}
# the public config.json of deepseek-ai/DeepSeek-V2-Lite (its fields the port reads)
DEEPSEEK_V2_LITE = {
    'architectures': ['DeepseekV2ForCausalLM'], 'model_type': 'deepseek_v2',
    'hidden_size': 2048, 'intermediate_size': 10944, 'moe_intermediate_size': 1408,
    'num_hidden_layers': 27, 'first_k_dense_replace': 1, 'num_attention_heads': 16,
    'num_key_value_heads': 16, 'q_lora_rank': None, 'kv_lora_rank': 512,
    'qk_nope_head_dim': 128, 'qk_rope_head_dim': 64, 'v_head_dim': 128,
    'n_routed_experts': 64, 'n_shared_experts': 2, 'num_experts_per_tok': 6,
    'moe_layer_freq': 1, 'topk_method': 'greedy', 'n_group': 1, 'topk_group': 1,
    'norm_topk_prob': False, 'routed_scaling_factor': 1.0, 'scoring_func': 'softmax',
    'vocab_size': 102400, 'max_position_embeddings': 163840, 'rms_norm_eps': 1e-06,
    'rope_theta': 10000,
    'rope_scaling': {'beta_fast': 32, 'beta_slow': 1, 'factor': 40, 'mscale': 0.707,
                     'mscale_all_dim': 0.707, 'original_max_position_embeddings': 4096,
                     'type': 'yarn'},
    'attention_bias': False, 'tie_word_embeddings': False, 'bos_token_id': 100000,
    'eos_token_id': 100001, 'torch_dtype': 'bfloat16',
}
# the quantization_config of deepseek-ai/DeepSeek-V3's native release: e4m3 weights
# with one f32 scale_inv per 128 x 128 block; V2-Lite's routed experts are seeded in
# this form on the card
FP8_BLOCKED = {'activation_scheme': 'dynamic', 'fmt': 'e4m3', 'quant_method': 'fp8',
               'weight_block_size': [128, 128]}
# the public config.json of deepseek-ai/DeepSeek-V3 (its fields the port reads)
DEEPSEEK_V3 = {
    'architectures': ['DeepseekV3ForCausalLM'], 'model_type': 'deepseek_v3',
    'hidden_size': 7168, 'intermediate_size': 18432, 'moe_intermediate_size': 2048,
    'num_hidden_layers': 61, 'first_k_dense_replace': 3, 'num_attention_heads': 128,
    'num_key_value_heads': 128, 'q_lora_rank': 1536, 'kv_lora_rank': 512,
    'qk_nope_head_dim': 128, 'qk_rope_head_dim': 64, 'v_head_dim': 128,
    'n_routed_experts': 256, 'n_shared_experts': 1, 'num_experts_per_tok': 8,
    'n_group': 8, 'topk_group': 4, 'topk_method': 'noaux_tc', 'norm_topk_prob': True,
    'routed_scaling_factor': 2.5, 'scoring_func': 'sigmoid', 'vocab_size': 129280,
    'max_position_embeddings': 163840, 'rms_norm_eps': 1e-06, 'rope_theta': 10000,
    'rope_scaling': {'beta_fast': 32, 'beta_slow': 1, 'factor': 40, 'mscale': 1.0,
                     'mscale_all_dim': 1.0, 'original_max_position_embeddings': 4096,
                     'type': 'yarn'},
    'tie_word_embeddings': False, 'bos_token_id': 0, 'eos_token_id': 1,
    'torch_dtype': 'bfloat16', 'quantization_config': FP8_BLOCKED,
}
# the 8-bit forms of Llama-3.1-8B: the SmoothQuant W8A8 config lite/smooth_quant.py
# writes, and the quantization_config of meta-llama/Llama-3.1-8B-Instruct-FP8
# (fbgemm_fp8: e4m3 weights, one f32 scale per output channel)
LLAMA31_8B_W8A8 = dict(LLAMA31_8B, quantization_config={'quant_method': 'smooth_quant',
                                                        'bits': 8})
LLAMA31_8B_FP8 = dict(LLAMA31_8B, quantization_config={'quant_method': 'fbgemm_fp8',
                                                       'activation_scale_ub': 1200.0})
# the public config.json of Qwen/Qwen3-8B-FP8 (its fields the port reads): every linear
# in e4m3 with one scale_inv per 128 x 128 block
QWEN3_8B_FP8 = {
    'architectures': ['Qwen3ForCausalLM'], 'model_type': 'qwen3',
    'hidden_size': 4096, 'intermediate_size': 12288, 'num_hidden_layers': 36,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'head_dim': 128,
    'vocab_size': 151936, 'max_position_embeddings': 40960, 'rms_norm_eps': 1e-06,
    'rope_theta': 1000000, 'attention_bias': False, 'tie_word_embeddings': False,
    'bos_token_id': 151643, 'eos_token_id': 151645, 'torch_dtype': 'bfloat16',
    'quantization_config': FP8_BLOCKED,
}
# the public config.json of microsoft/Phi-3.5-MoE-instruct (its fields the port reads;
# its longrope factor lists, 64 published numbers each, are seeded in phimoe_config, and
# original_max_position_embeddings sits in rope_scaling, where the reference reads it)
PHI35_MOE = {
    'architectures': ['PhiMoEForCausalLM'], 'model_type': 'phimoe',
    'hidden_size': 4096, 'intermediate_size': 6400, 'num_hidden_layers': 32,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'num_local_experts': 16,
    'num_experts_per_tok': 2, 'vocab_size': 32064, 'max_position_embeddings': 131072,
    'original_max_position_embeddings': 4096, 'rms_norm_eps': 1e-05, 'rope_theta': 10000.0,
    'router_jitter_noise': 0.01, 'attention_bias': True, 'lm_head_bias': True,
    'tie_word_embeddings': False, 'bos_token_id': 1, 'eos_token_id': 32000,
    'torch_dtype': 'bfloat16',
}
# the public config.json of zai-org/GLM-4.5-Air (its fields the port reads)
GLM45_AIR = {
    'architectures': ['Glm4MoeForCausalLM'], 'model_type': 'glm4_moe',
    'hidden_size': 4096, 'intermediate_size': 10944, 'moe_intermediate_size': 1408,
    'num_hidden_layers': 46, 'first_k_dense_replace': 1, 'num_attention_heads': 96,
    'num_key_value_heads': 8, 'head_dim': 128, 'partial_rotary_factor': 0.5,
    'n_routed_experts': 128, 'n_shared_experts': 1, 'num_experts_per_tok': 8,
    'n_group': 1, 'topk_group': 1, 'norm_topk_prob': True, 'routed_scaling_factor': 1.0,
    'vocab_size': 151552, 'max_position_embeddings': 131072, 'rms_norm_eps': 1e-05,
    'rope_theta': 1000000, 'attention_bias': True, 'use_qk_norm': False,
    'tie_word_embeddings': False, 'eos_token_id': [151329, 151336, 151338],
    'torch_dtype': 'bfloat16',
}
# the public config.json of deepseek-ai/deepseek-moe-16b-base (its fields the port reads)
DEEPSEEK_MOE_16B = {
    'architectures': ['DeepseekForCausalLM'], 'model_type': 'deepseek',
    'hidden_size': 2048, 'intermediate_size': 10944, 'moe_intermediate_size': 1408,
    'num_hidden_layers': 28, 'first_k_dense_replace': 1, 'num_attention_heads': 16,
    'num_key_value_heads': 16, 'n_routed_experts': 64, 'n_shared_experts': 2,
    'num_experts_per_tok': 6, 'moe_layer_freq': 1, 'norm_topk_prob': False,
    'scoring_func': 'softmax', 'vocab_size': 102400, 'max_position_embeddings': 4096,
    'rms_norm_eps': 1e-06, 'rope_theta': 10000, 'attention_bias': False,
    'tie_word_embeddings': False, 'bos_token_id': 100000, 'eos_token_id': 100001,
    'torch_dtype': 'bfloat16',
}
# the public config.json of google/gemma-2-9b-it (its fields the port reads): a window
# of 4,096 on the even layers, attention and final logit softcaps, a 256k tied vocab
GEMMA2_9B = {
    'architectures': ['Gemma2ForCausalLM'], 'model_type': 'gemma2',
    'hidden_size': 3584, 'intermediate_size': 14336, 'num_hidden_layers': 42,
    'num_attention_heads': 16, 'num_key_value_heads': 8, 'head_dim': 256,
    'vocab_size': 256000, 'max_position_embeddings': 8192, 'rms_norm_eps': 1e-06,
    'rope_theta': 10000.0, 'attention_bias': False, 'query_pre_attn_scalar': 256,
    'attn_logit_softcapping': 50.0, 'final_logit_softcapping': 30.0,
    'sliding_window': 4096, 'bos_token_id': 2, 'eos_token_id': 1,
    'torch_dtype': 'bfloat16',
}
# the public config.json of THUDM/GLM-4-9B-0414 (its fields the port reads): 32 / 2
# heads (G 16), rope on half of each head in pair order, sandwich norms
GLM4_9B = {
    'architectures': ['Glm4ForCausalLM'], 'model_type': 'glm4',
    'hidden_size': 4096, 'intermediate_size': 13696, 'num_hidden_layers': 40,
    'num_attention_heads': 32, 'num_key_value_heads': 2, 'head_dim': 128,
    'partial_rotary_factor': 0.5, 'vocab_size': 151552, 'max_position_embeddings': 32768,
    'rms_norm_eps': 1e-05, 'rope_theta': 10000.0, 'attention_bias': True,
    'tie_word_embeddings': False, 'eos_token_id': [151329, 151336, 151338],
    'torch_dtype': 'bfloat16',
}
# the public config.json of bigcode/starcoder2-7b (its fields the port reads; it names
# no tie_word_embeddings, so the transformers default, True, holds): 36 / 4 heads (G 9),
# LayerNorm, biases, an ungated MLP and a window of 4,096 on every layer
STARCODER2_7B = {
    'architectures': ['Starcoder2ForCausalLM'], 'model_type': 'starcoder2',
    'hidden_size': 4608, 'intermediate_size': 18432, 'num_hidden_layers': 32,
    'num_attention_heads': 36, 'num_key_value_heads': 4, 'vocab_size': 49152,
    'max_position_embeddings': 16384, 'norm_epsilon': 1e-05, 'rope_theta': 1000000,
    'sliding_window': 4096, 'use_bias': True, 'bos_token_id': 0, 'eos_token_id': 0,
    'torch_dtype': 'bfloat16',
}
# the engine's switches of each W4A16 schedule (read when the ModelAgent is built), and
# the kernel each runs
W4_SCHEDULES = {'gd': {}, 'fast': {'LMDEPLOY_TPU_W4_FAST': '1'},
                'precise': {'LMDEPLOY_TPU_W4_SCHED': 'precise'},
                'unprepared': {'LMDEPLOY_TPU_W4_STACKED': '0'}}
W4_KERNEL_OF = {'gd': 'w4a16_gemm', 'fast': 'w4a16_szc', 'precise': 'w4a16_szc',
                'unprepared': 'w4a16_unprepared'}


def emit(obj):
    print(json.dumps(obj), flush=True)


# a plain version is timed as a yardstick only, and some take 50 ms a call: fewer
# replays keep the kernel phases short
PLAIN_TIMING = {'iters': 3, 'reps': 2, 'warmup': 1}


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 10) -> float:
    """Device time of one ``fn`` call: ``fn`` is captured once into a CUDA graph
    (after ``warmup`` eager calls), the graph is replayed ``reps`` times between
    two CUDA events, and the median over ``iters`` such timings, divided by
    ``reps``, is returned.  Replaying a graph keeps the host's per-call launch
    overhead (Python, ctypes, allocator) out of the kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def compare(out: torch.Tensor, ref: torch.Tensor, tol: dict):
    """(max abs error, max error relative to |ref| where |ref| >= atol, worst error
    as a fraction of the allowance ``tol``)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    allow = tol['atol'] + tol['rtol'] * ref.abs()
    rel = err / ref.abs().clamp_min(tol['atol'])
    return err.max().item(), rel.max().item(), (err / allow).max().item()


def bound(flops: float, nbytes: float):
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes')


def tinyllama_config(num_layers: int = 22, max_len: int = 2304):
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig(num_layers=num_layers, num_attention_heads=32,
                       num_key_value_heads=4, hidden_size=2048, intermediate_size=5632,
                       vocab_size=32000, head_dim=64, max_position_embeddings=max_len,
                       dtype='bfloat16', eos_token_id=[2])


def gptoss_config(num_layers: int = 24):
    """gpt-oss-20b (its public config) with MXFP4 experts, depth cut to ``num_layers``
    (one sliding and one full layer at 2)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig.from_hf_config(dict(GPT_OSS_20B, num_hidden_layers=num_layers,
                                           layer_types=GPT_OSS_20B['layer_types'][:num_layers]))


# the Llama-3.1-8B e2e phases' depth (the KV cells, the CP cell and the speculative
# cells' target), cut from the config's 32 layers so the script stays well inside its
# time limit (to 8 when the decode_graphs phase joined the CP cell, to 4 when the
# speculative cells joined, to 2 when the MTP / DSA cells joined); width, heads, vocab
# and the traffic stay as published
L31 = 2
# the TinyLlama e2e phase's depth, cut from its 22 layers when the MTP / DSA cells joined
LTINY = 8
# the Mixtral-8x7B and gpt-oss-20b e2e phases' depth, cut from 32 and 24 layers for
# the same reason (Mixtral's to 4: with the overlap each prefill wave waits behind a
# decode run that widens every expert of every layer at each step); and the W4A16 +
# int8 cell's (llama2-7b, 32 layers) and DeepSeek-V2-Lite's (27), cut to 8 each when
# the dense variants' cells joined the script; gpt-oss-20b's to 4 (two sliding, two
# full layers), Mixtral's to 2, the W4A16 + int8 and DeepSeek-V2-Lite cells' to 4 when
# the speculative cells joined; gpt-oss-20b's (one sliding, one full layer), the W4A16 +
# int8 and DeepSeek-V2-Lite (one dense, one MoE layer) cells' to 2 when the MTP / DSA
# cells joined; width, experts, vocab and traffic stay as published
LMIX = 2
LGPT = 2
LW4 = 2
LDS = 2


def llama31_config(num_layers: int = 32):
    """Llama-3.1-8B (its public config), depth cut to ``num_layers``."""
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig.from_hf_config(dict(LLAMA31_8B, num_hidden_layers=num_layers))


def mixtral_config(num_layers: int = 32):
    """Mixtral-8x7B (its public config) with AWQ W4A16 weights, depth cut to
    ``num_layers``."""
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig.from_hf_config(dict(MIXTRAL_8X7B, num_hidden_layers=num_layers))


def deepseek_config(num_layers: int = 27):
    """DeepSeek-V2-Lite (its public config) with its routed experts in DeepSeek-V3's
    native blocked-fp8 form, depth cut to ``num_layers`` (at 2: the dense layer and one
    MoE layer)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig.from_hf_config(dict(DEEPSEEK_V2_LITE, num_hidden_layers=num_layers,
                                           quantization_config=FP8_BLOCKED))


def llama7b_w4_config(num_layers: int = 32, max_len: int = 2304):
    """llama2-7b geometry (bench.py:240-246) with AWQ W4A16, group 128."""
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig(num_layers=num_layers, num_attention_heads=32,
                       num_key_value_heads=32, hidden_size=4096, intermediate_size=11008,
                       vocab_size=32000, head_dim=128, max_position_embeddings=max_len,
                       dtype='bfloat16', eos_token_id=[2],
                       quantization_config={'quant_method': 'awq', 'group_size': 128})


# -- phase 1 + 2 ---------------------------------------------------------------------
def device_phase():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    info = {'phase': 'device', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(), 'nvidia_smi': smi,
            'torch': torch.__version__, 'cuda': torch.version.cuda}
    emit(info)
    return info


# the sources whose kernels issue wgmma, whose SASS the build phase reads
WGMMA_SOURCES = ('flash_prefill', 'w4a16_gemm', 'w4a16_gemm_szc', 'w4a16_gemm_unprepared',
                 'fp8_bmm', 'mxfp4_bmm')


def wgmma_waits(lib: str) -> dict:
    """{kernel: [HGMMA count, full waits (WARPGROUP.DEPBAR.LE gsb0, 0x0)]} from the
    library's SASS: as many full waits as HGMMAs means ptxas serialised every wgmma
    (it does so without a warning when it cannot keep their register operands apart)."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([cuobjdump, '-sass', lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in sass.split('Function : ')[1:]:
        name = fn.split('\n', 1)[0].strip()
        short = re.search(r'(\w+_kernel)I(.*?)EEv', name)
        key = f'{short.group(1)}<{short.group(2)}>' if short else name[-60:]
        out[key] = [fn.count('HGMMA.'), fn.count('WARPGROUP.DEPBAR.LE gsb0, 0x0')]
    return {k: v for k, v in out.items() if v[0]}


# the sources whose narrow decodes issue mma.sync on codes decoded in registers (or on
# 2-byte / e4m3 / int8 elements, narrow_decode.cuh's body), and the part of the kernels'
# names that picks them
MMA_SYNC_SOURCES = {'paged_decode_int4': '_mma', 'paged_decode_turbo': '_mma',
                    'paged_decode': 'paged_decode_narrowI', 'paged_decode_int8': '_mma',
                    'paged_decode_cp': '_mma'}


def _kernel_key(name: str) -> str:
    short = re.search(r'(paged_decode_\w+?)I(.*?)EEv', name)
    return f'{short.group(1)}<{short.group(2)}>' if short else name[-60:]


def mma_sync_chains(lib: str) -> dict:
    """{kernel: [HMMA count, HMMAs whose accumulator is the result of the HMMA before
    them]} from the library's SASS: such an HMMA waits for the one before it, so the
    second count is the mma.sync kernels' serialised MMAs."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([cuobjdump, '-sass', lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in sass.split('Function : ')[1:]:
        prev, n, dep = None, 0, 0
        for m in re.finditer(r'HMMA\.\S+ (R\d+), R\d+, R\d+, (R\w+)', fn):
            n += 1
            dep += m.group(2) == prev
            prev = m.group(1)
        if n:
            out[_kernel_key(fn.split('\n', 1)[0].strip())] = [n, dep]
    return out


def ptxas_by_kernel(log: str, pattern: str = '_mma') -> dict:
    """{kernel: [registers, spill bytes stored + loaded]} from an nvcc -Xptxas -v log,
    for the entry functions whose name holds ``pattern``."""
    out, key = {}, None
    with open(log) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                key = _kernel_key(m.group(1)) if pattern in m.group(1) else None
            elif key and ('spill' in ln or 'registers' in ln):
                entry = out.setdefault(key, [None, 0])
                if 'spill' in ln:
                    entry[1] = sum(int(x) for x in re.findall(r'(\d+) bytes spill', ln))
                used = re.search(r'Used (\d+) registers', ln)
                if used:
                    entry[0] = int(used.group(1))
                    key = None
    return out


def build_phase():
    from lmdeploy_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    seconds = cuda_build.build()
    regs = {}
    for name in cuda_build.SOURCES:
        with open(cuda_build.log_path(name)) as f:
            regs[name] = [ln.strip() for ln in f if 'registers' in ln or 'spill' in ln]
    emit({'phase': 'build', 'wall_s': time.perf_counter() - t0, 'per_source_s': seconds,
          'ptxas': regs,
          'wgmma_waits': {n: wgmma_waits(cuda_build.lib_path(n)) for n in WGMMA_SOURCES},
          'mma_sync_decodes': {n: {'registers_spills': ptxas_by_kernel(cuda_build.log_path(n),
                                                                        pattern),
                                   'hmma_dependent': mma_sync_chains(cuda_build.lib_path(n))}
                               for n, pattern in MMA_SYNC_SOURCES.items()}})


# -- phase 3 -------------------------------------------------------------------------
def flash_phase():
    from lmdeploy_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                      flash_prefill_attention_plain)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    results = []
    # TinyLlama at T=2048 (the main path's long prompt), a ragged T with D=128 and
    # G=1 (llama2-7b heads), and the 8x128 prefill batch of the e2e phase; MLA's latent
    # head (one kv head of 576, V the latent and 64 zeros, scale 1/sqrt(192)) under
    # DeepSeek-V2-Lite's 16 and V3's 128 query heads at the e2e phase's 1024-token
    # chunks; the other head dims the kernel takes (96, 256) and the f16 and f32 models;
    # Llama-3.1-8B's fresh prefill step in the e2e_llama31 cells (8 x 1,024 tokens),
    # Qwen2-7B's G = 7 (28 / 4 heads) at T 2048 and Qwen2-1.5B's G = 6 (12 / 2) in f16
    # at a ragged T: 128-row blocks that are not a whole number of positions;
    # GLM-4.5-Air's G = 12 (96 / 8 heads) at the e2e_glm45_air cell's long prompt and
    # its prefill batch of 16 x 256, and GLM-4-9B's G = 16 (32 / 2) at e2e_glm4_9b's;
    # Llama-3.1-8B's prefill wave of 16 x 256 in the speculative cells; DeepSeek-V3's
    # (MLA under 128 query heads) in spec_mtp_deepseek_v3; Qwen3-Next-80B-A3B's
    # full-attention layers (16 / 2 heads, G 8, D 256) at e2e_qwen3_next_80b_a3b's long
    # prompt and its prefill wave of 16 x 256
    for label, B, T, Hq, Hkv, D, dtype in (
            ('tinyllama_t2048', 1, 2048, 32, 4, 64, 'bfloat16'),
            ('d128_g1', 1, 1000, 32, 32, 128, 'bfloat16'),
            ('e2e_batch', 8, 128, 32, 4, 64, 'bfloat16'),
            ('mla_v2_lite', 1, 1024, 16, 1, 576, 'bfloat16'),
            ('mla_v3', 1, 1024, 128, 1, 576, 'bfloat16'),
            ('d96', 2, 500, 32, 32, 96, 'bfloat16'), ('d256', 2, 500, 8, 4, 256, 'bfloat16'),
            ('d80_f16', 2, 300, 32, 32, 80, 'float16'),
            ('mla_v2_lite_f16', 1, 300, 16, 1, 576, 'float16'),
            ('d192_f32', 1, 200, 8, 2, 192, 'float32'),
            ('mla_v2_lite_f32', 1, 200, 16, 1, 576, 'float32'),
            ('llama31_8b_b8_t1024', 8, 1024, 32, 8, 128, 'bfloat16'),
            ('qwen2_7b_g7_t2048', 1, 2048, 28, 4, 128, 'bfloat16'),
            ('qwen2_1p5b_g6_f16', 2, 300, 12, 2, 128, 'float16'),
            ('glm45_air_t2048', 1, 2048, 96, 8, 128, 'bfloat16'),
            ('glm45_air_b16_t256', 16, 256, 96, 8, 128, 'bfloat16'),
            ('glm4_9b_t2048', 1, 2048, 32, 2, 128, 'bfloat16'),
            ('glm4_9b_b16_t256', 16, 256, 32, 2, 128, 'bfloat16'),
            ('llama31_8b_b16_t256', 16, 256, 32, 8, 128, 'bfloat16'),
            ('mla_v3_b16_t256', 16, 256, 128, 1, 576, 'bfloat16'),
            ('qwen3_next_t4096', 1, 4096, 16, 2, 256, 'bfloat16'),
            ('qwen3_next_b16_t256', 16, 256, 16, 2, 256, 'bfloat16')):
        dt = getattr(torch, dtype)
        q = torch.randn(B, T, Hq, D, device='cuda', generator=gen).to(dt)
        k = torch.randn(B, T, Hkv, D, device='cuda', generator=gen).to(dt)
        v = torch.randn(B, T, Hkv, D, device='cuda', generator=gen).to(dt)
        scale = D ** -0.5
        if label.startswith('mla'):
            v[..., 512:] = 0
            scale = 192 ** -0.5
        out = flash_prefill_attention(q, k, v, scale)
        ref = flash_prefill_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        tol = KERNEL_TOL['flash_prefill']
        err, rel, frac = compare(out, ref, tol)
        ok = bool(torch.isfinite(out.float()).all()) and frac <= 1.0
        flops = 2 * 2 * B * Hq * D * T * (T + 1) / 2           # QK^T and PV, causal
        # q, o, k, v in their dtype
        nbytes = q.element_size() * (2 * B * T * Hq * D + 2 * B * T * Hkv * D)
        bound_ms, bound_by = bound(flops, nbytes)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = torch.nn.functional.scaled_dot_product_attention
        try:           # a yardstick only: SDPA's backends may refuse a head dim
            library_ms = time_ms(lambda: lib(qt, kt, vt, is_causal=True, scale=scale,
                                             enable_gqa=True))
        except RuntimeError as e:
            library_ms = None
            emit({'phase': 'kernel', 'kernel': 'flash_prefill', 'case': label,
                  'library': f'SDPA refused: {str(e)[:200]}'})
        row = {'phase': 'kernel', 'kernel': 'flash_prefill', 'case': label,
               'shape': [B, T, Hq, Hkv, D], 'dtype': dtype,
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol, 'ok': ok,
               'kernel_ms': time_ms(lambda: flash_prefill_attention(q, k, v, scale)),
               'plain_ms': time_ms(lambda: flash_prefill_attention_plain(q, k, v, scale),
                                   **PLAIN_TIMING),
               'library_ms': library_ms,
               'bound_ms': bound_ms, 'bound_by': bound_by, 'gflop': flops / 1e9}
        emit(row)
        results.append(row)
        if not ok:
            raise SystemExit(f'flash_prefill disagrees with its plain version: {row}')
    return results


def _decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens, L=2, dtype=torch.bfloat16):
    """A 2-layer cache with ragged rows on disjoint random pages, trailing padding
    rows on block 0 (kv_len 1, as the engine pads), and kv_len 0 where ``lens`` says."""
    NB = 1 + B * W
    cache = torch.randn(L, NB, 2, BS, Hkv * D, device='cuda', generator=gen).to(dtype)
    perm = torch.randperm(NB - 1, device='cuda', generator=gen) + 1
    tables = perm[:B * W].reshape(B, W).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
    pad_rows = kv_lens < 0
    tables[pad_rows] = 0
    kv_lens[pad_rows] = 1
    q = torch.randn(B, Hq, D, device='cuda', generator=gen).to(dtype)
    return q, cache, tables.contiguous(), kv_lens


def plain_layout_path(D: int, q_dtype: torch.dtype, page_dtype: torch.dtype) -> str:
    """The body of csrc/paged_decode.cu that its dispatch gives a call, for the rows'
    labels: 'narrow tensor cores' (bf16 / f16 q over 2-byte or e4m3 pages at D 64 / 128,
    any block size), 'narrow cuda cores' (the other D <= 128 calls over those pages),
    'wide tensor cores' (2-byte pages above D 128) or 'wide cuda cores' (f32 pages, e4m3
    above 128)."""
    size = torch.empty((), dtype=page_dtype).element_size()
    if D <= 128 and size <= 2:
        mma = q_dtype != torch.float32 and D in (64, 128)
        return 'narrow tensor cores' if mma else 'narrow cuda cores'
    return 'wide tensor cores' if size == 2 else 'wide cuda cores'


# the narrow path's split length (tokens) swept at the cases of the e2e cells' decode
# shapes, each held against the plain version
NARROW_SPLIT_SWEEP = (256, 512, 1024, 2048)
NARROW_SWEEP_CASES = ('plain', 'e2e_long', 'gptoss_sliding', 'gptoss_full', 'd128_g1',
                      'glm45_air', 'glm4_9b', 'starcoder2_7b')
# the dense cells' sessions (their long prompts and 32 tokens in 128-token pages)
DENSE_W = (6144 + 128 + 127) // 128
# the option each decode trap of the dense cells' cases leaves out
DECODE_TRAP_OPT = {'softcap_left_out': 'logit_softcap', 'window_left_out': 'window'}


def decode_cases():
    """decode_phase's cases, (label, B, Hq, Hkv, D, lens, W, opts): lens marks padding
    rows -1; opts may give q's dtype, the block size (default 128), window, softcap,
    sinks (True: drawn with the case) and a factor on q (``q_scale``)."""
    rng = np.random.RandomState(SEED)
    # bs64 TinyLlama heads, ragged lengths averaging ~384, one inactive row and
    # four padding rows (marked -1); then a D=128, G=1 (llama2-7b heads) case
    lens64 = rng.randint(1, 768, size=64)
    lens64[5] = 0
    lens64[-4:] = -1
    lens8 = rng.randint(1, 1024, size=8)
    # the e2e phase's decode shape: a 16-row bucket, 8 rows of ~200 tokens, one of
    # ~2,100, 7 padding rows, the full session-wide table width
    lens16 = np.concatenate([rng.randint(130, 200, size=8), [2100], -np.ones(7, int)])
    # e2e_gptoss_mxfp4's decode shape: gpt-oss-20b heads (64 / 8, D 64), the 64-row
    # bucket with 32 rows of 129-192 tokens, one of 2,049-2,112 and 31 padding rows,
    # sinks on every layer; the sliding layers' window of 128 (one whole page), the
    # full layers' none
    lens_gptoss = np.concatenate([rng.randint(129, 193, size=32), rng.randint(2049, 2113, 1),
                                  -np.ones(31, int)])
    # e2e_deepseek_v2_lite_fp8's decode shape: MLA's one latent kv head of 576 under
    # 16 query heads (V3: 128), the 64-row bucket with 63 rows of 1,025-1,088 tokens and
    # one of 4,097-4,160, the session-wide table width
    lens_mla = np.concatenate([rng.randint(1025, 1089, size=63), rng.randint(4097, 4161, 1)])
    w_mla = (4096 + 128 + 127) // 128
    # the narrow path's edges: rows of 2,000-4,000 tokens under a window of 1,500 (it
    # covers a whole split of 1,024 tokens, and the splits before it hold nothing) with
    # sinks; rows all shorter than one split in a 33-page table; block size 8 (a warp's
    # 16 rows on two pages, 263 pages a row) and 16 (a sub-chunk across 4 pages) on the
    # tensor-core body, Llama-3.1-8B heads, one inactive row
    lens_long = rng.randint(2000, 4000, size=16)
    lens_short = rng.randint(1, 1000, size=64)
    lens_short[9] = 0
    lens_small = np.concatenate([rng.randint(1, 300, size=12), [2100], [0], -np.ones(2, int)])
    # the decode shape of the 8-bit and MoE cells (e2e_glm45_air's heads: 96 / 8, G 12, a
    # warp's 16 rows part padding): the 64-row bucket with 63 rows of 257-288 tokens and
    # one of 2,049-2,080, the 17-page table
    lens_cells = np.concatenate([rng.randint(257, 289, size=63), rng.randint(2049, 2081, 1)])
    # (its own stream, so that the cases above and below keep their lengths)
    spec_rng = np.random.RandomState(SEED + 17)
    lens_spec = np.concatenate([spec_rng.randint(257, 353, size=63),
                                spec_rng.randint(2049, 2145, 1)])
    # the dense cells' decode shapes, 63 rows of 257-288 tokens and one long row:
    # Gemma-2-9B's (16 / 8 heads, D 256, softcap 50; its even layers' window of 4,096,
    # which the long row of 6,145-6,176 tokens has outgrown; q scaled so that the scores
    # spread as parity_gemma2_9b's raw prefill scores do: std 23.16 / 23.11 on its two
    # layers, max |s| 125, its attn_score_std on H100 80GB HBM3 at 700 W), GLM-4-9B's
    # G 16 (32 / 2, D 128; the long row 2,049-2,080) and StarCoder2-7B's G 9 (36 / 4,
    # D 128, the window of 4,096 on every layer)
    lens_long_window = np.concatenate([rng.randint(257, 289, size=63),
                                       rng.randint(6145, 6177, 1)])
    gemma2 = {'logit_softcap': 50.0, 'q_scale': 23.0, 'held_traps': ('softcap_left_out',)}
    # e2e_qwen3_next_80b_a3b's decode shape (its own stream): Qwen3-Next-80B-A3B's
    # full-attention heads (16 / 2, G 8, D 256: the wide path), the 64-row bucket with 63
    # rows of 257-288 tokens and one of 4,097-4,128, the 33-page table
    qn_rng = np.random.RandomState(SEED + 19)
    lens_qn = np.concatenate([qn_rng.randint(257, 289, size=63), qn_rng.randint(4097, 4129, 1)])
    return [
        ('plain', 64, 32, 4, 64, lens64, 8, {}),
        ('window', 64, 32, 4, 64, lens64, 8, {'window': 200}),
        ('softcap', 64, 32, 4, 64, lens64, 8, {'logit_softcap': 30.0}),
        ('sinks', 64, 32, 4, 64, lens64, 8, {'sinks': True}),
        ('all', 64, 32, 4, 64, lens64, 8, {'window': 100, 'logit_softcap': 20.0,
                                           'sinks': True}),
        ('d128_g1', 8, 32, 32, 128, lens8, 8, {}),
        ('e2e_long', 16, 32, 4, 64, lens16, 17, {}),
        ('gptoss_sliding', 64, 64, 8, 64, lens_gptoss, 17, {'window': 128, 'sinks': True}),
        ('gptoss_full', 64, 64, 8, 64, lens_gptoss, 17, {'sinks': True}),
        ('window_covers_split', 16, 32, 8, 128, lens_long, 33, {'window': 1500,
                                                                'sinks': True}),
        ('rows_shorter_than_a_split', 64, 32, 8, 128, lens_short, 33, {}),
        ('bs8', 16, 32, 8, 128, lens_small, 263, {'block_size': 8, 'sinks': True}),
        ('bs16_window', 16, 32, 8, 128, lens_small, 132, {'block_size': 16, 'window': 300}),
        ('plain_f16', 64, 32, 4, 64, lens64, 8, {'dtype': torch.float16}),
        ('mla_v2_lite', 64, 16, 1, 576, lens_mla, w_mla, {}),
        ('mla_v3', 64, 128, 1, 576, lens_mla, w_mla, {}),
        ('d96', 16, 32, 32, 96, lens16, 17, {}),
        ('d256_window', 16, 8, 4, 256, lens16, 17, {'window': 300, 'sinks': True}),
        ('d80_f16', 16, 32, 32, 80, lens16, 17, {'dtype': torch.float16}),
        ('mla_v2_lite_f16', 16, 16, 1, 576, lens16, 17, {'dtype': torch.float16}),
        ('d192_f32', 16, 8, 2, 192, lens16, 17, {'dtype': torch.float32}),
        ('mla_v2_lite_f32', 16, 16, 1, 576, lens16, 17, {'dtype': torch.float32}),
        ('glm45_air', 64, 96, 8, 128, lens_cells, 17, {}),
        ('gemma2_9b', 64, 16, 8, 256, lens_long_window, DENSE_W,
         dict(gemma2, window=4096, held_traps=('softcap_left_out', 'window_left_out'))),
        ('gemma2_9b_full', 64, 16, 8, 256, lens_long_window, DENSE_W, gemma2),
        ('glm4_9b', 64, 32, 2, 128, lens_cells, 17, {}),
        # the speculative cells' draft decodes: the EAGLE-3 head's one layer (32 / 8
        # heads, D 128) and Llama-3.2-1B's (32 / 8, D 64), over the draft cache at the
        # cells' lengths (63 rows of 257-352 tokens, one of 2,049-2,144)
        ('spec_eagle3_head', 64, 32, 8, 128, lens_spec, 17, {}),
        ('spec_llama32_1b_draft', 64, 32, 8, 64, lens_spec, 17, {}),
        # DeepSeek-V3's MTP head over its one-layer cache in spec_mtp_deepseek_v3 (MLA's
        # latent head of 576 under 128 query heads), the same lengths
        ('mla_v3_spec_mtp_head', 64, 128, 1, 576, lens_spec, 17, {}),
        ('starcoder2_7b', 64, 36, 4, 128, lens_long_window, DENSE_W,
         {'window': 4096, 'held_traps': ('window_left_out',)}),
        ('qwen3_next_80b', 64, 16, 2, 256, lens_qn, L31_W, {}),
    ]


def decode_phase():
    """paged_decode against its plain version at every case of decode_cases: each row's
    body, the plain two passes of the split paths, the narrow path's combine trap and,
    at the e2e cells' shapes, its split length swept."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                     paged_decode_attention_plain)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    results = []
    for label, B, Hq, Hkv, D, lens, W, opts in decode_cases():
        opts = dict(opts)
        dtype = opts.pop('dtype', torch.bfloat16)
        BS = opts.pop('block_size', 128)
        q_scale = opts.pop('q_scale', 1.0)
        held_traps = opts.pop('held_traps', ())
        q, cache, tables, kv_lens = _decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens,
                                                   dtype=dtype)
        q = (q.float() * q_scale).to(dtype)
        if label.startswith('mla'):
            cache[:, :, 1, :, 512:] = 0          # the V plane: the latent and 64 zeros
        if opts.get('sinks'):
            opts['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
        scale = 192 ** -0.5 if label.startswith('mla') else D ** -0.5
        layer = 1

        def kern():
            return paged_decode_attention(q, cache, tables, kv_lens, layer, scale, Hkv,
                                          **opts)

        def plain():
            return paged_decode_attention_plain(q, cache, tables, kv_lens, layer, scale,
                                                Hkv, **opts)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        tol = KERNEL_TOL['paged_decode']
        err, rel, frac = compare(out, ref, tol)
        zero_ok = bool((out[kv_lens == 0] == 0).all())
        path = plain_layout_path(D, dtype, cache.dtype)
        split = {'path': path, 'split_tokens': pd.narrow_split_tokens(D, cache.dtype, B),
                 'splits': pd.plain_layout_splits(D, cache.dtype, B, W, BS, opts.get('window')),
                 'split_plain_err_over_tol': compare(pd.paged_decode_attention_split_plain(
                     q, cache, tables, kv_lens, layer, scale, Hkv, **opts), ref, tol)[2]}
        # the dense cells' cases: the softcap or the window left out must read beyond the
        # tolerance (the scores reach the cap; a row has outgrown the window)
        traps = {trap: compare(paged_decode_attention_plain(
            q, cache, tables, kv_lens, layer, scale, Hkv,
            **dict(opts, **{DECODE_TRAP_OPT[trap]: None})), ref, tol)[2]
            for trap in held_traps}
        if path.startswith('narrow') and int((kv_lens > BS).sum()):
            traps['combine_without_alpha'] = compare(_split_plain_trapped(
                'paged_decode', q, cache, tables, kv_lens, layer, scale, Hkv,
                opts.get('logit_softcap'), opts.get('window'), opts.get('sinks')), ref, tol)[2]
        ok = (bool(torch.isfinite(out.float()).all()) and frac <= 1.0 and zero_ok
              and split['split_plain_err_over_tol'] <= 1.0
              and all(t > 1.0 for t in traps.values()))
        # bytes this data needs: each row's in-window K and V rows, q and out
        lens_np = kv_lens.cpu().numpy().astype(np.int64)
        win = opts.get('window') or 0
        toks = np.minimum(lens_np, win) if win else lens_np
        el = cache.element_size()
        nbytes = toks.sum() * Hkv * D * 2 * el + el * (2 * B * Hq * D)
        flops = 4 * Hq * D * toks.sum()
        bound_ms, bound_by = bound(flops, nbytes)
        row = {'phase': 'kernel', 'kernel': 'paged_decode', 'case': label,
               'shape': [B, Hq, Hkv, D, BS, W], 'dtype': str(dtype).split('.')[-1],
               'mean_kv_len': float(lens_np.mean()), 'max_kv_len': int(lens_np.max()), **split,
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
               'zero_rows_ok': zero_ok, 'trap_err_over_tol': traps, 'ok': ok,
               'kernel_ms': time_ms(kern), 'plain_ms': time_ms(plain, **PLAIN_TIMING),
               'library_ms': None, 'bound_ms': bound_ms, 'bound_by': bound_by,
               'kv_mbytes': nbytes / 1e6}
        # the split of a row's pages over blocks, swept: the tensor-core wide path's at
        # the MLA shapes, the narrow path's at the e2e cells' shapes
        sweep = {'mla_v2_lite': ('SPLIT_TOKENS_MMA', (512, 1024, 2048)),
                 'mla_v3': ('SPLIT_TOKENS_MMA', (512, 1024, 2048)),
                 'qwen3_next_80b': ('SPLIT_TOKENS_MMA', (256, 512, 1024, 2048)),
                 **{c: ('SPLIT_TOKENS_NARROW', NARROW_SPLIT_SWEEP)
                    for c in NARROW_SWEEP_CASES}}.get(label)
        if sweep:
            const, lengths = sweep
            chosen = getattr(pd, const)
            # each length timed twice, in turns
            row['split_tokens_ms'] = {t: [] for t in lengths}
            row['split_tokens_err_over_tol'] = {}
            for _ in range(2):
                for tokens in lengths:
                    setattr(pd, const, tokens)
                    row['split_tokens_err_over_tol'][tokens] = compare(kern(), ref, tol)[2]
                    row['split_tokens_ms'][tokens].append(time_ms(kern))
            setattr(pd, const, chosen)
            row['ok'] = ok = ok and max(row['split_tokens_err_over_tol'].values()) <= 1.0
        emit(row)
        results.append(row)
        del q, cache, tables, kv_lens
        if not ok:
            raise SystemExit(f'paged_decode disagrees with its plain version, or its check '
                             f'misses a trap: {row}')
    torch.cuda.empty_cache()
    return results


# one llama2-7b layer's W4A16 projections (fused as the model runs them), K x N
W4_LAYER = (('wqkv', 4096, 12288), ('wo', 4096, 4096), ('w_gateup', 4096, 22016),
            ('w_down', 11264, 4096))
# the e2e phase decodes 65 rows, padded to the 128-row batch bucket: its every
# w4a16_gemm launch runs at M = 128 (the e2e row's ``w4a16_rows`` shows it)
W4_MAIN_M = 128
# the layer at M = 128 and 64, the fused wqkv at M = 1, 8 and 65 (the e2e phase's row
# count before its 128-row bucket), the fused gate/up at M = 256 (the kernel's largest
# M) and Mixtral-8x7B's fused wqkv at its decode bucket; the shapes at M = 64 and 128
# also run every K split in W4_SPLITS, each held against the plain version
W4_SHAPES = tuple((f'{n}_m{M}', M, K, N) for M in (W4_MAIN_M, 64) for n, K, N in W4_LAYER) \
    + (('wqkv_m8', 8, 4096, 12288), ('w_gateup_m256', 256, 4096, 22016),
       ('wqkv_m1', 1, 4096, 12288), ('wqkv_m65', 65, 4096, 12288),
       ('mixtral_wqkv_m64', 64, 4096, 6144))
W4_SPLITS = (1, 2, 4, 8)
# the W4A16 numerical traps (ROADMAP section 3, traps 1 and 3, and the output kept
# f32 until corr is subtracted), planted in the plain group-dot (_gd_trapped): the
# kernel check and the W4A16 parity must each read every one above its allowance
W4_TRAPS = ('tf32_correction', 'xg_unrounded', 'rounded_before_correction')


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties to even), the milder of
    the two ways a TF32 tensor-core product reads an f32 operand (the other truncates)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


def _gd_trapped(trap: str):
    """``w4a16_matmul_gd_plain`` with one trap planted: 'tf32_correction' rounds xg and
    corr to TF32 for the correction product (trap 1); 'xg_unrounded' sums xg from x as
    given instead of from the bf16 x the main product reads (trap 3; it shows only
    where x is wider than bf16); 'rounded_before_correction' rounds the ~50x-larger
    main product to x.dtype before corr is subtracted."""
    from lmdeploy_tpu_torch.ops.quant_matmul import _nibbles_u8, _xg

    def gd(x, packed, sb, corr, gs):
        M, K = x.shape
        G, N = K // gs, packed.shape[1]
        xb = x.to(torch.bfloat16)
        w = (_nibbles_u8(packed).float() + 128.0).view(G, gs, N)
        acc = (torch.bmm(xb.float().view(M, G, gs).transpose(0, 1), w)
               * sb[:, None, :]).sum(0)
        xg, cz = _xg(xb, gs), corr
        if trap == 'tf32_correction':
            xg, cz = _tf32(xg), _tf32(corr)
        elif trap == 'xg_unrounded':
            xg = x.float().view(M, G, gs).sum(-1)
        elif trap == 'rounded_before_correction':
            acc = acc.to(x.dtype).float()
        return (acc - (xg[:, :, None] * cz[None]).sum(1)).to(x.dtype)
    return gd


def _int4pack_library(x, packed, scales, zeros, gs):
    """One PyTorch call for the same product, as a yardstick only:
    torch._weight_int4pack_mm computes x @ ((q - 8) * s + zero), so zero = (8 - z) * s
    maps the zero points.  Returns (fn, None) or (None, error text)."""
    from lmdeploy_tpu_torch.ops.quant_matmul import _nibbles_u8
    try:
        q = _nibbles_u8(packed).t().contiguous()                     # [N, K] 0..15
        u8 = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8)
        wpack = torch._convert_weight_to_int4pack(u8, 8)
        sz = torch.stack([scales, (8.0 - zeros) * scales], dim=-1).bfloat16().contiguous()

        def fn():
            return torch._weight_int4pack_mm(x, wpack, gs, sz)
        fn()
        return fn, None
    except Exception as e:        # noqa: BLE001 -- recorded as the yardstick's absence
        return None, f'{type(e).__name__}: {str(e)[:200]}'


def w4a16_phase():
    from lmdeploy_tpu_torch.ops.quant_matmul import (dequant_w4, prep_w4, quantize_w4,
                                                     token_tile, w4a16_matmul_gd,
                                                     w4a16_matmul_gd_plain, w4a16_splits)
    torch.backends.cuda.matmul.allow_tf32 = False     # the correction must stay f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gs = 128
    results = []
    for label, M, K, N in W4_SHAPES:
        w = (torch.randn(K, N, device='cuda', generator=gen) * 0.02).bfloat16()
        packed, scales, zeros = quantize_w4(w, gs)
        sb, corr = prep_w4(scales, zeros, mode='gd')
        x32 = torch.randn(M, K, device='cuda', generator=gen)
        x = x32.bfloat16()
        out = w4a16_matmul_gd(x, packed, sb, corr, gs)
        ref = w4a16_matmul_gd_plain(x, packed, sb, corr, gs)
        torch.cuda.synchronize()
        tol = KERNEL_TOL['w4a16_gemm']
        err, rel, frac = compare(out, ref, tol)
        ok = bool(torch.isfinite(out.float()).all()) and frac <= 1.0
        # what the same check reads with each trap planted (x32: x before bf16 rounding)
        traps = {t: compare(_gd_trapped(t)(x32 if t == 'xg_unrounded' else x, packed, sb,
                                           corr, gs).bfloat16(), ref, tol)[2]
                 for t in W4_TRAPS}
        ok = ok and min(traps.values()) > 1.0
        # every K split the kernel takes, each held against the plain version
        G = K // gs
        sweep = {}
        for s in W4_SPLITS if M in (W4_MAIN_M, 64) else ():
            frac_s = compare(w4a16_matmul_gd(x, packed, sb, corr, gs, splits=s), ref, tol)[2]
            sweep[s] = {'ms': time_ms(lambda: w4a16_matmul_gd(x, packed, sb, corr, gs,
                                                              splits=s)),
                        'err_over_tol': frac_s}
            ok = ok and frac_s <= 1.0
        nbytes = K * N // 2 + 2 * 4 * G * N + 2 * M * K + 2 * M * N + 4 * M * G
        bound_ms, bound_by = bound(2 * M * K * N, nbytes)
        lib, lib_error = _int4pack_library(x, packed, scales, zeros, gs)
        lib_err = None if lib is None else (lib().float() - ref.float()).abs().max().item()
        wd = dequant_w4(packed, scales, zeros, gs)
        row = {'phase': 'kernel', 'kernel': 'w4a16_gemm', 'case': label,
               'shape': [M, K, N, gs], 'max_abs_err': err, 'max_rel_err': rel,
               'err_over_tol': frac, 'tol': tol, 'ok': ok, 'tf32': False,
               'trap_err_over_tol': traps, 'splits': w4a16_splits(M, N, G, sms),
               'tile': {'tokens': token_tile(M), 'columns': 128,
                        'token_tiles': -(-M // token_tile(M)), 'column_tiles': -(-N // 128)},
               'split_sweep': sweep,
               'kernel_ms': time_ms(lambda: w4a16_matmul_gd(x, packed, sb, corr, gs)),
               'plain_ms': time_ms(lambda: w4a16_matmul_gd_plain(x, packed, sb, corr, gs),
                                   **PLAIN_TIMING),
               'library_ms': time_ms(lib) if lib is not None else None,
               'library': 'torch._weight_int4pack_mm', 'library_error': lib_error,
               'library_max_abs_err': lib_err,
               'dense_bf16_ms': time_ms(lambda: torch.matmul(x, wd)),
               'bound_ms': bound_ms, 'bound_by': bound_by, 'mbytes': nbytes / 1e6}
        emit(row)
        results.append(row)
        del w, wd
        if not ok:
            raise SystemExit(f'w4a16_gemm disagrees with its plain version at some split, '
                             f'or its check misses a trap: {row}')
    return results


# one Mixtral-8x7B layer's W4A16 attention projections (fused wqkv, wo), K x N; its
# e2e phases decode in the 64-row bucket.  Beside them llama2-7b's projections but its
# wo, which has Mixtral's shape
MIX_LAYER = (('mixtral_wqkv', 4096, 6144), ('mixtral_wo', 4096, 4096))
MIX_MAIN_M = 64
W4_MODE_SHAPES = tuple((f'{n}_m{M}', M, K, N)
                       for n, K, N in MIX_LAYER + tuple(('7b_' + n, K, N) for n, K, N in W4_LAYER
                                                        if n != 'wo')
                       for M in (1, 8, 37, MIX_MAIN_M, 128, 256))
# numerical traps planted in the plain versions (ROADMAP section 3), each of which the
# check must read above its allowance: fast's corr from the unrounded scales (trap 2),
# xg from unrounded x (trap 3) and a TF32 correction (trap 1), all on its ~30x bias
# term, and its bf16 scale applied in f32 to each group's dot output (the gd numerics)
# instead of to each weight with a bf16 rounding; precise's subtrahend 128 instead of
# 135 and its scale on the dot outputs.  Precise's corr (z - 7)*s is signal-sized by
# design, so traps 1-3 move it by a fraction of a bf16 ulp and are not planted there.
# Its weights (q - 7)*s round at 1/18 of fast's (128 + q)*s: the scale-on-the-dot-
# outputs trap differs from precise by those roundings alone, at most 2^-9 of each
# |x_k (q_k - 7) s|, which reads 2.1-5.8x the kernel allowance on every shape (an
# H100 80GB HBM3 at 700 W), and is held here; in the parity phase the bf16 rounding
# of every activation and output is of the same size, so there it reads within the
# floor and is reported only (SZC_PARITY_REPORTED).  The unprepared product: zeros
# ignored, planes 1 and 2 swapped, a TF32 correction
SZC_TRAPS = {'fast': ('corr_unrounded_scales', 'xg_unrounded', 'tf32_correction',
                      'scale_on_dot_outputs'),
             'precise': ('subtrahend_128', 'scale_on_dot_outputs')}
SZC_PARITY_REPORTED = {'fast': (), 'precise': ('scale_on_dot_outputs',)}
UNPREP_TRAPS = ('zeros_ignored', 'plane_order_swapped', 'tf32_correction')


def _szc_trapped(trap: str, scales=None, zeros=None):
    """``w4a16_matmul_szc_plain`` with one trap planted; 'corr_unrounded_scales' builds
    corr from the raw f32 ``scales`` and ``zeros``."""
    from lmdeploy_tpu_torch.ops.quant_matmul import C135, _nibbles_u8, _xg, schedule_of

    def szc(x, packed, sb, corr, gs):
        precise = schedule_of(sb, corr) == 'precise'
        M, K = x.shape
        G, N = K // gs, packed.shape[1]
        xb = x.to(torch.bfloat16)
        sub = 128.0 if trap == 'subtrahend_128' else C135 if precise else 0.0
        q = (_nibbles_u8(packed).float() + (128.0 - sub)).view(G, gs, N)
        s = sb.float()[:, None, :]
        if trap == 'scale_on_dot_outputs':
            acc = (torch.bmm(xb.float().view(M, G, gs).transpose(0, 1), q) * s).sum(0)
        else:
            acc = xb.float() @ (q * s).to(torch.bfloat16).float().view(K, N)
        xg = x.float().view(M, G, gs).sum(-1) if trap == 'xg_unrounded' else _xg(xb, gs)
        if precise:
            xg = xg.to(torch.bfloat16).float()
        cz = corr.float()
        if trap == 'corr_unrounded_scales':
            raw = scales.float()
            cz = (((zeros.float() - 7.0) * raw).to(torch.bfloat16).float() if precise
                  else (zeros.float() + 128.0) * raw)
        if trap == 'tf32_correction':
            xg, cz = _tf32(xg), _tf32(cz)
        return (acc - (xg[:, :, None] * cz[None]).sum(1)).to(x.dtype)
    return szc


def _unprep_trapped(trap: str):
    """``w4a16_matmul_plain`` with one trap planted in its group-dot (the dense route
    above 256 rows is the reference's and stays as it is)."""
    from lmdeploy_tpu_torch.ops.quant_matmul import (_dense_route, _nibbles_u8, _xg,
                                                     w4a16_dense)

    def mm(x, packed, scales, zeros, gs):
        if _dense_route(x, gs):
            return w4a16_dense(x, packed, scales, zeros, gs)
        M, K = x.shape
        G, N = K // gs, packed.shape[1]
        xb = x.to(torch.bfloat16)
        q = _nibbles_u8(packed).float()
        if trap == 'plane_order_swapped':
            q = q.view(4, K // 4, N)[[0, 2, 1, 3]].reshape(K, N)
        s = scales.float()
        acc = (torch.bmm(xb.float().view(M, G, gs).transpose(0, 1),
                         (q + 128.0).view(G, gs, N)) * s[:, None, :]).sum(0)
        z = torch.zeros_like(s) if trap == 'zeros_ignored' else zeros.float()
        xg, cz = _xg(xb, gs), (z + 128.0) * s
        if trap == 'tf32_correction':
            xg, cz = _tf32(xg), _tf32(cz)
        return (acc - (xg[:, :, None] * cz[None]).sum(1)).to(x.dtype)
    return mm


def w4a16_modes_phase():
    """w4a16_szc (fast and precise) and w4a16_unprepared against their plain versions
    on the card, at Mixtral-8x7B's fused wqkv and wo and llama2-7b's four projections,
    M 1 to 256, with each mode's planted traps, and at every K split of W4_SPLITS
    (each held against the plain version and timed: ``split_sweep``); beside each, the
    bound, the plain version's time, torch._weight_int4pack_mm's and a dense bf16
    GEMM's on the same weights.  Returns (szc rows, unprepared rows)."""
    from lmdeploy_tpu_torch.ops.quant_matmul import (dequant_w4, prep_w4, quantize_w4,
                                                     w4a16_matmul, w4a16_matmul_plain,
                                                     w4a16_matmul_szc,
                                                     w4a16_matmul_szc_plain, w4a16_splits)
    torch.backends.cuda.matmul.allow_tf32 = False     # the corrections must stay f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gs = 128
    out_rows = {'w4a16_szc': [], 'w4a16_unprepared': []}
    weights = {}
    for label, M, K, N in W4_MODE_SHAPES:
        if (K, N) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            w = (torch.randn(K, N, device='cuda', generator=gen) * 0.02).bfloat16()
            packed, scales, zeros = quantize_w4(w, gs)
            weights[(K, N)] = (packed, scales, zeros, dequant_w4(packed, scales, zeros, gs),
                               {m: prep_w4(scales, zeros, mode=m) for m in ('fast', 'precise')})
            del w
        packed, scales, zeros, wd, prepped = weights[(K, N)]
        G = K // gs
        x32 = torch.randn(M, K, device='cuda', generator=gen)
        x = x32.bfloat16()
        lib, lib_error = _int4pack_library(x, packed, scales, zeros, gs)
        common = {'phase': 'kernel', 'case': label, 'shape': [M, K, N, gs], 'tf32': False,
                  'splits': w4a16_splits(M, N, G, sms),
                  'library_ms': time_ms(lib) if lib is not None else None,
                  'library': 'torch._weight_int4pack_mm', 'library_error': lib_error,
                  'dense_bf16_ms': time_ms(lambda: torch.matmul(x, wd))}
        cases = [('w4a16_szc', mode, (sb, corr), w4a16_matmul_szc, w4a16_matmul_szc_plain,
                  {t: _szc_trapped(t, scales, zeros) for t in SZC_TRAPS[mode]},
                  G * N * (2 + corr.element_size()))
                 for mode, (sb, corr) in prepped.items()]
        cases.append(('w4a16_unprepared', 'unprepared', (scales, zeros), w4a16_matmul,
                      w4a16_matmul_plain, {t: _unprep_trapped(t) for t in UNPREP_TRAPS},
                      G * N * 8))
        for kernel, mode, (ta, tb), kern, plain, traps, table_bytes in cases:
            out = kern(x, packed, ta, tb, gs)
            ref = plain(x, packed, ta, tb, gs)
            torch.cuda.synchronize()
            tol = KERNEL_TOL[kernel]
            err, rel, frac = compare(out, ref, tol)
            ok = bool(torch.isfinite(out.float()).all()) and frac <= 1.0
            reads = {t: compare(fn(x32 if t == 'xg_unrounded' else x, packed, ta, tb,
                                   gs).bfloat16(), ref, tol)[2]
                     for t, fn in traps.items()}
            ok = ok and min(reads.values()) > 1.0
            # every K split the kernel takes, each held against the plain version
            sweep = {}
            for sp in W4_SPLITS:
                frac_s = compare(kern(x, packed, ta, tb, gs, splits=sp), ref, tol)[2]
                sweep[sp] = {'ms': time_ms(lambda: kern(x, packed, ta, tb, gs, splits=sp)),
                             'err_over_tol': frac_s}
                ok = ok and frac_s <= 1.0
            nbytes = K * N // 2 + table_bytes + 2 * M * K + 2 * M * N + 4 * M * G
            bound_ms, bound_by = bound(2 * M * K * N, nbytes)
            row = dict(common, kernel=kernel, mode=mode, max_abs_err=err, max_rel_err=rel,
                       err_over_tol=frac, tol=tol, ok=ok, trap_err_over_tol=reads,
                       split_sweep=sweep,
                       kernel_ms=time_ms(lambda: kern(x, packed, ta, tb, gs)),
                       plain_ms=time_ms(lambda: plain(x, packed, ta, tb, gs), **PLAIN_TIMING),
                       bound_ms=bound_ms, bound_by=bound_by, mbytes=nbytes / 1e6)
            emit(row)
            out_rows[kernel].append(row)
            if not ok:
                raise SystemExit(f'{kernel} ({mode}) disagrees with its plain version at '
                                 f'some split, or its check misses a trap: {row}')
    weights.clear()
    torch.cuda.empty_cache()
    return out_rows['w4a16_szc'], out_rows['w4a16_unprepared']


def _int8_decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens, L=2, dtype=torch.bfloat16):
    """A 2-layer int8 cache, every slot of every page (the padding block's too) filled
    through the port's fill_kv_cache from random bf16 K/V, so each row's pages hold
    random stale tokens past its length; ragged rows on disjoint random pages, trailing
    padding rows on block 0 (kv_len 1, as the engine pads), kv_len 0 where ``lens``
    says; q in ``dtype``."""
    from lmdeploy_tpu_torch.ops.attention import fill_kv_cache
    from lmdeploy_tpu_torch.ops.kv_quant import QuantKV
    NB = 1 + B * W
    cache = QuantKV(torch.zeros(L, NB, 2, BS, Hkv * D, dtype=torch.int8, device='cuda'),
                    torch.zeros(L, NB, 2, BS, Hkv, device='cuda'))
    slots = torch.arange(0, NB * BS, device='cuda')
    for layer in range(L):
        k = torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16()
        v = torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16()
        fill_kv_cache(cache, k, v, slots, layer)
        del k, v
    perm = torch.randperm(NB - 1, device='cuda', generator=gen) + 1
    tables = perm[:B * W].reshape(B, W).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
    pad_rows = kv_lens < 0
    tables[pad_rows] = 0
    kv_lens[pad_rows] = 1
    q = torch.randn(B, Hq, D, device='cuda', generator=gen).to(dtype)
    return q, cache, tables.contiguous(), kv_lens


def int8_decode_cases():
    """decode_int8_phase's cases, (label, B, Hq, Hkv, D, lens, W, softcap, q dtype):
    lens marks padding rows -1."""
    rng = np.random.RandomState(SEED + 1)
    # bs64 at llama2-7b heads (G 1), ragged lengths averaging ~384, one inactive row and
    # four padding rows; the same with a softcap; TinyLlama heads (G = 8, D = 64); the
    # e2e_w4a16_kv8 phase's decode shape: 64 rows of ~200 tokens, one of ~2,100, padding
    # rows up to the 128-row bucket, the session-wide table width
    lens64 = rng.randint(1, 768, size=64)
    lens64[5] = 0
    lens64[-4:] = -1
    lens_e2e = np.concatenate([rng.randint(130, 200, size=64), [2100],
                               -np.ones(63, int)])
    # the other paths: f16 q at D 256 (two query blocks of 8 heads) and D 192 on the
    # tensor cores, f32 q and D 80 on the CUDA cores; 8 rows of 130-199 tokens, one of
    # 2,100, one inactive, six padding rows
    lens16 = np.concatenate([rng.randint(130, 200, size=8), [2100], [0], -np.ones(6, int)])
    return [('bs64_7b', 64, 32, 32, 128, lens64, 8, None, torch.bfloat16),
            ('softcap_7b', 64, 32, 32, 128, lens64, 8, 30.0, torch.bfloat16),
            ('bs64_tinyllama_heads', 64, 32, 4, 64, lens64, 8, None, torch.bfloat16),
            ('e2e_shape_7b', 128, 32, 32, 128, lens_e2e, 17, None, torch.bfloat16),
            ('d256_g16_f16', 16, 32, 2, 256, lens16, 17, None, torch.float16),
            ('d192', 16, 16, 4, 192, lens16, 17, None, torch.bfloat16),
            ('d128_f32', 16, 32, 8, 128, lens16, 17, 30.0, torch.float32),
            ('d80', 16, 32, 8, 80, lens16, 17, None, torch.bfloat16)]


def decode_int8_phase():
    """paged_decode_int8 against its plain version at every case of int8_decode_cases
    (caches filled by the port's fill, random stale slots past every row's length): its
    split length swept (each held against the plain version), the plain two passes
    (each split's partials, then the combine) and their combine trap at one split a
    page."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    results = []
    BS = 128
    for label, B, Hq, Hkv, D, lens, W, softcap, dtype in int8_decode_cases():
        q, cache, tables, kv_lens = _int8_decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens,
                                                        dtype=dtype)
        scale = D ** -0.5
        layer = 1

        def kern():
            return pd.paged_decode_attention_int8(q, cache, tables, kv_lens, layer, scale,
                                                  Hkv, logit_softcap=softcap)

        def plain():
            return pd.paged_decode_attention_int8_plain(q, cache, tables, kv_lens, layer,
                                                        scale, Hkv, logit_softcap=softcap)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        tol = KERNEL_TOL['paged_decode_int8']
        err, rel, frac = compare(out, ref, tol)
        zero_ok = bool((out[kv_lens == 0] == 0).all())
        traps = {}
        if int((kv_lens > BS).sum()):
            traps['combine_without_alpha'] = compare(_split_plain_trapped(
                'paged_decode_int8', q, cache, tables, kv_lens, layer, scale, Hkv, softcap),
                ref, tol)[2]
        # the constant that sets this batch's split, swept
        const = 'SPLIT_TOKENS_INT8_SMALL' if B <= pd.INT8_SMALL_BATCH else 'SPLIT_TOKENS_INT8'
        chosen = getattr(pd, const)
        split = {'path': ('tensor cores' if D in pd.MMA_QUANT_HEAD_DIMS
                          and dtype != torch.float32 else 'cuda cores'),
                 'split_tokens': chosen, 'splits': pd.int8_splits(W, BS, D, B),
                 'split_plain_err_over_tol': compare(pd.paged_decode_attention_int8_split_plain(
                     q, cache, tables, kv_lens, layer, scale, Hkv, logit_softcap=softcap),
                     ref, tol)[2],
                 'split_tokens_ms': {}, 'split_tokens_err_over_tol': {}}
        for tokens in KV_SPLIT_SWEEP:
            setattr(pd, const, tokens)
            split['split_tokens_err_over_tol'][tokens] = compare(kern(), ref, tol)[2]
            split['split_tokens_ms'][tokens] = time_ms(kern)
        setattr(pd, const, chosen)
        ok = (bool(torch.isfinite(out.float()).all()) and frac <= 1.0 and zero_ok
              and all(v > 1.0 for v in traps.values())
              and split['split_plain_err_over_tol'] <= 1.0
              and max(split['split_tokens_err_over_tol'].values()) <= 1.0)
        # bytes this data needs: each row's int8 K and V rows and their f32 scales
        toks = kv_lens.cpu().numpy().astype(np.int64).sum()
        nbytes = toks * Hkv * (2 * D + 2 * 4) + 2 * q.element_size() * B * Hq * D
        bound_ms, bound_by = bound(4 * Hq * D * toks, nbytes)
        row = {'phase': 'kernel', 'kernel': 'paged_decode_int8', 'case': label,
               'shape': [B, Hq, Hkv, D, BS, W], 'softcap': softcap,
               'dtype': str(dtype).split('.')[-1], **split,
               'mean_kv_len': float(kv_lens.float().mean()), 'max_kv_len': int(lens.max()),
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
               'zero_rows_ok': zero_ok, 'trap_err_over_tol': traps, 'ok': ok,
               'kernel_ms': time_ms(kern), 'plain_ms': time_ms(plain, **PLAIN_TIMING),
               'library_ms': None, 'bound_ms': bound_ms, 'bound_by': bound_by,
               'kv_mbytes': nbytes / 1e6}
        emit(row)
        results.append(row)
        del q, cache
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f'paged_decode_int8 disagrees with its plain version, or its '
                             f'check misses a trap: {row}')
    return results


# gpt-oss-20b's expert products: gate / up take x [M, 2880] shared by the 32 experts,
# down takes x [32, M, 2880]; M = 64 is the e2e phase's decode bucket (its every
# launch runs there), 8 and 37 (ragged) smaller batches, 128 a dense-combine chunk of
# a prefill under 768 tokens
MX_E, MX_H = 32, 2880
MX_MAIN_M = 64
MX_DENSE_MAX_M = 767           # the dense combine's largest M (ops/moe.py)
# (label, x kind, M, K): gpt-oss-20b's K = 2880 (1,440 byte rows a half: the kernel's
# last 64-row stage is half past the half) at every M, prefill chunks up to 767 rows
# included, and K = 192 (3 scale groups a half, a stage and a half)
MX_SHAPES = tuple((f'{kind}_m{M}', kind, M, MX_H)
                  for M in (MX_MAIN_M, 8, 37, 128, MX_DENSE_MAX_M)
                  for kind in ('gate', 'down')) \
    + (('k192_gate_m37', 'gate', 37, 192), ('k192_down_m64', 'down', 64, 192))
# numerical traps planted in the plain version (ROADMAP section 3): the high nibbles
# read with the low half's scale rows; code 9 decoded as +0.5 (a sign slip).  The
# kernel rows also plant the rows of the last half-stage read from the next expert's
# first byte rows (and scale rows) against the x columns past the half, where the
# kernel must read zeros
MX_TRAPS = ('hi_with_lo_scales', 'code9_positive')
MX_KERNEL_TRAPS = MX_TRAPS + ('tail_from_next_expert',)
# the exact decode: every code of both nibbles, times scales that are not powers of
# two, of either sign, near f32's ends, and whose products fall below bf16's normal
# range, widened by the kernel (x = unit rows) and by the plain version, bit for bit
MX_EXACT_SCALES = (1.0, 0.3, 1.0 / 3.0, 7.77, -0.7, 6.1e-5, 2.0 ** -126, 5.0e37, 1.0e-40,
                   -3.0e-39)
# and scales such as a checkpoint holds (ue8m0: powers of two, from 2^-127 up), with
# products down in bf16's subnormal range
MX_EXACT_POW2_SCALES = (1.0, 0.5, 2.0, -2.0 ** -3, 2.0 ** -9, 2.0 ** -126, 2.0 ** -127,
                        2.0 ** -100, 1.5, 2.0 ** -120)


def _mx_trapped(trap: str):
    """``mxfp4_bmm_plain`` with one trap planted."""
    from lmdeploy_tpu_torch.ops.quant_bmm import decode_e2m1, widen_mxfp4

    if trap == 'tail_from_next_expert':
        def tail(x, nib, scale):
            E, K2, N = nib.shape
            pad = (-K2) % 64            # the byte rows past the half in its last stage
            ref = torch.matmul(x.to(torch.bfloat16).float(),
                               widen_mxfp4(nib, scale).float())
            if not pad:
                return ref
            nxt = torch.roll(torch.arange(E, device=nib.device), -1)
            # the next expert's first byte rows' low nibbles, scaled by its first rows
            w = decode_e2m1(nib[nxt, :pad] & 0xF) * scale[nxt, :1].float()
            xs = x.to(torch.bfloat16).float()[..., K2:K2 + pad]
            return ref + torch.matmul(xs, w.to(torch.bfloat16).float())
        return tail

    def widen(nib, scale):
        lo, hi = decode_e2m1(nib & 0xF), decode_e2m1(nib >> 4)
        if trap == 'code9_positive':
            hi = torch.where((nib >> 4) == 9, 0.5, hi)
            lo = torch.where((nib & 0xF) == 9, 0.5, lo)
        G2 = scale.shape[-2] // 2
        s_hi = scale[..., :G2, :] if trap == 'hi_with_lo_scales' else scale[..., G2:, :]
        *lead, K2, N = lo.shape

        def scaled(v, s):
            return (v.view(*lead, G2, K2 // G2, N) * s.unsqueeze(-2)).view(*lead, K2, N)
        return torch.cat([scaled(lo, scale[..., :G2, :]), scaled(hi, s_hi)], dim=-2)

    def bmm(x, nib, scale):
        w = widen(nib, scale).to(torch.bfloat16).float()
        return torch.matmul(x.to(torch.bfloat16).float(), w)
    return bmm


def mxfp4_phase():
    from lmdeploy_tpu_torch.ops.quant_bmm import mxfp4_bmm, mxfp4_bmm_plain, widen_mxfp4
    from lmdeploy_tpu_torch.ops.quant_matmul import token_tile
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain version's sums are f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    E, K, N = MX_E, MX_H, MX_H
    # codes uniform, group scales 2^-9 .. 2^-5 (varied, so the scale-row trap shows)
    nib = torch.randint(0, 256, (E, K // 2, N), generator=gen, device='cuda',
                        dtype=torch.uint8)
    scale = torch.exp2(torch.randint(-9, -4, (E, K // 32, N), generator=gen,
                                     device='cuda').float())
    wd = widen_mxfp4(nib, scale)                      # bf16 [E, K, N], the yardstick's
    stacks = {K: (nib, scale, wd)}
    results = [_mx_exact_row(gen, 'exact_codes_x_scales', MX_EXACT_SCALES),
               _mx_exact_row(gen, 'exact_codes_x_pow2_scales', MX_EXACT_POW2_SCALES)]
    for row in results:
        emit(row)
        if not row['ok']:
            raise SystemExit(f'mxfp4_bmm does not widen every code exactly: {row}')
    for label, kind, M, K in MX_SHAPES:
        if K not in stacks:
            kn = torch.randint(0, 256, (E, K // 2, N), generator=gen, device='cuda',
                               dtype=torch.uint8)
            ks = torch.exp2(torch.randint(-9, -4, (E, K // 32, N), generator=gen,
                                          device='cuda').float())
            stacks[K] = (kn, ks, widen_mxfp4(kn, ks))
        nib, scale, wd = stacks[K]
        shape = (M, K) if kind == 'gate' else (E, M, K)
        x = torch.randn(shape, device='cuda', generator=gen).bfloat16()
        out = mxfp4_bmm(x, nib, scale)
        ref = mxfp4_bmm_plain(x, nib, scale)
        torch.cuda.synchronize()
        tol = KERNEL_TOL['mxfp4_bmm']
        err, rel, frac = compare(out, ref, tol)
        traps = {t: compare(_mx_trapped(t)(x, nib, scale), ref, tol)[2]
                 for t in MX_KERNEL_TRAPS}
        ok = (bool(torch.isfinite(out).all()) and out.shape == (E, M, N) and frac <= 1.0
              and min(traps.values()) > 1.0)
        nbytes = nib.numel() + 4 * scale.numel() + 2 * x.numel() + 4 * E * M * N
        bound_ms, bound_by = bound(2 * E * M * K * N, nbytes)
        dense = (lambda: torch.matmul(x, wd)) if kind == 'gate' else (lambda: torch.bmm(x, wd))
        row = {'phase': 'kernel', 'kernel': 'mxfp4_bmm', 'case': label,
               'shape': [E, M, K, N], 'x': 'shared' if kind == 'gate' else 'per expert',
               'token_tile': token_tile(M),
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
               'ok': ok, 'tf32': False, 'trap_err_over_tol': traps,
               'kernel_ms': time_ms(lambda: mxfp4_bmm(x, nib, scale)),
               'plain_ms': time_ms(lambda: mxfp4_bmm_plain(x, nib, scale), **PLAIN_TIMING),
               'library_ms': None,
               'library': 'none: no PyTorch call multiplies MXFP4 weights on sm_90',
               'dense_bf16_ms': time_ms(dense),
               'bound_ms': bound_ms, 'bound_by': bound_by, 'mbytes': nbytes / 1e6}
        emit(row)
        results.append(row)
        if not ok:
            raise SystemExit(f'mxfp4_bmm disagrees with its plain version, or its check '
                             f'misses a trap: {row}')
    del nib, scale, wd, stacks
    torch.cuda.empty_cache()
    return results


def _mx_exact_row(gen, case: str, scales) -> dict:
    """mxfp4_bmm against the plain widening, bit for bit: every byte value in every
    scale group of both halves, the scales drawn from ``scales``, x the unit rows
    (out[e, m, n] is then weight row m exactly: one product by 1, the rest by 0)."""
    from lmdeploy_tpu_torch.ops.quant_bmm import mxfp4_bmm, widen_mxfp4
    E, K, N = 2, 128, 256
    r = torch.arange(K // 2, device='cuda')[:, None]
    n = torch.arange(N, device='cuda')[None, :]
    nib = torch.stack([(r * 7 + n * 13 + e) % 256 for e in range(E)]).to(torch.uint8)
    pick = torch.randint(0, len(scales), (E, K // 32, N), generator=gen, device='cuda')
    scale = torch.tensor(scales, device='cuda')[pick].contiguous()
    x = torch.eye(K, device='cuda').bfloat16()
    out = mxfp4_bmm(x, nib, scale)
    ref = widen_mxfp4(nib, scale).float()
    torch.cuda.synchronize()
    same = out == ref
    return {'phase': 'kernel', 'kernel': 'mxfp4_bmm', 'case': case,
            'shape': [E, K, K, N], 'scales': list(scales),
            'codes_seen': int(torch.unique(nib).numel()),
            'mismatches': int((~same).sum()), 'ok': bool(same.all()),
            'max_abs_err': (out - ref).abs().max().item()}


# fp8_bmm's shapes: DeepSeek-V2-Lite's experts (E 64, H 2048, Ie 1408) at the e2e decode
# bucket M = 64 and at 8, 37, 128 and 767, gate (x shared) and down (x per expert); and
# DeepSeek-V3's (E 256, H 7168, Ie 2048) at M = 64
FP8_MAIN_M = 64
FP8_V2L = (64, 2048, 1408)
FP8_V3 = (256, 7168, 2048)
FP8_DENSE_MAX_M = 767          # the dense combine's largest M (ops/moe.py)
# V3 at M 64 (the e2e decode bucket) and 320 (spec_mtp_deepseek_v3's verify: 64 rows x
# (SPEC_K + 1) positions)
FP8_SHAPES = tuple((f'v2_lite_{kind}_m{M}', FP8_V2L, kind, M)
                   for M in (FP8_MAIN_M, 8, 37, 128, FP8_DENSE_MAX_M)
                   for kind in ('gate', 'down')) \
    + tuple((f'v3_{kind}_m{M}', FP8_V3, kind, M) for M in (FP8_MAIN_M, 320)
            for kind in ('gate', 'down'))
# numerical traps the check must catch, each planted in the plain version: x left
# unrounded (the rows check with an f32 x, which the kernel rounds to bf16); each group
# read with the next group's scale row; the e4m3 NaN code decoded natively (NaN, where
# the reference reads +-480; planted as 0x7f / 0xff bytes in a copy of w8)
FP8_TRAPS = ('x_unrounded', 'next_group_scale', 'native_nan')
# experts the plain version takes at once at V3's width (its f32 temporaries)
FP8_PLAIN_EXPERTS = 32


def _fp8_trapped(trap: str):
    """``fp8_bmm_plain`` with one trap planted."""
    from lmdeploy_tpu_torch.ops.quant_bmm import decode_fp8_e4m3

    def bmm(x, w8, gscale):
        K = w8.shape[-2]
        if trap == 'next_group_scale':
            gscale = torch.roll(gscale, -1, dims=-2)
        vals = w8.float() if trap == 'native_nan' else decode_fp8_e4m3(w8)
        w = (vals * gscale.float().repeat_interleave(K // gscale.shape[-2], dim=-2))
        xr = x.float() if trap == 'x_unrounded' else x.to(torch.bfloat16).float()
        return torch.matmul(xr, w.to(torch.bfloat16).float())
    return bmm


def _fp8_seeded(gen, E, K, N, group=128):
    """Expert stacks [E, K, N] in the model's seeded blocked-fp8 form."""
    from lmdeploy_tpu_torch.models.llama import init_fp8_leaf
    return (init_fp8_leaf('w8', (E, K, N), gen, 'cuda'),
            init_fp8_leaf('gscale', (E, K // group, N), gen, 'cuda'))


def _fp8_plain_chunked(x, w8, gscale):
    """``fp8_bmm_plain`` over FP8_PLAIN_EXPERTS experts at a time (the same function;
    V3's whole stacks would need ~60 GB of f32 temporaries)."""
    from lmdeploy_tpu_torch.ops.quant_bmm import fp8_bmm_plain
    E = w8.shape[0]
    step = FP8_PLAIN_EXPERTS
    return torch.cat([fp8_bmm_plain(x if x.dim() == 2 else x[e:e + step], w8[e:e + step],
                                    gscale[e:e + step]) for e in range(0, E, step)])


def eager_ms(fn, warmup: int = 1) -> float:
    """Device time of one eager ``fn`` call between two CUDA events (for a yardstick
    whose temporaries are too large to keep inside a CUDA graph)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def fp8_phase():
    """fp8_bmm against its plain version at DeepSeek-V2-Lite's and V3's expert
    products, with the traps of FP8_TRAPS at V2-Lite's; kernel times with the bf16 x of
    the model's path."""
    from lmdeploy_tpu_torch.ops.quant_bmm import (FP8_ITEM_COLUMNS, fp8_bmm, fp8_bmm_plain,
                                                  widen_fp8)
    from lmdeploy_tpu_torch.ops.quant_matmul import token_tile
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain version's sums are f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    results, stacks = [], {}
    tol = KERNEL_TOL['fp8_bmm']
    for label, (E, H, Ie), kind, M in FP8_SHAPES:
        K, N = (H, Ie) if kind == 'gate' else (Ie, H)
        key = (E, K, N)
        if key not in stacks:
            stacks.clear()
            torch.cuda.empty_cache()
            w8, gs = _fp8_seeded(gen, E, K, N)
            stacks[key] = (w8, gs, widen_fp8(w8, gs))     # bf16 [E, K, N], the yardstick's
        w8, gs, wd = stacks[key]
        v3 = E == FP8_V3[0]
        x32 = torch.randn((M, K) if kind == 'gate' else (E, M, K), device='cuda',
                          generator=gen)
        x = x32.bfloat16()
        out = fp8_bmm(x32, w8, gs)                        # the wrapper rounds x
        plain = _fp8_plain_chunked if v3 else fp8_bmm_plain
        ref = plain(x32, w8, gs)
        torch.cuda.synchronize()
        err, rel, frac = compare(out, ref, tol)
        ok = bool(torch.isfinite(out).all()) and out.shape == (E, M, N) and frac <= 1.0
        traps, nan_frac = {}, None
        if not v3:
            w8n = w8.clone()
            bytes_ = w8n.view(torch.uint8)
            bytes_[0, :9, :5] = 0x7F
            bytes_[E // 2, 5:9, 77] = 0xFF
            ref_n = fp8_bmm_plain(x32, w8n, gs)
            nan_frac = compare(fp8_bmm(x32, w8n, gs), ref_n, tol)[2]
            for t in FP8_TRAPS:
                w_t = w8n if t == 'native_nan' else w8
                got = _fp8_trapped(t)(x32, w_t, gs)
                traps[t] = compare(got.nan_to_num(nan=3e38), ref_n if t == 'native_nan'
                                   else ref, tol)[2]
            ok = ok and nan_frac <= 1.0 and min(traps.values()) > 1.0
            del w8n, ref_n
        nbytes = w8.numel() + 4 * gs.numel() + 2 * x.numel() + 4 * E * M * N
        bound_ms, bound_by = bound(2 * E * M * K * N, nbytes)
        dense = (lambda: torch.matmul(x, wd)) if kind == 'gate' else (lambda: torch.bmm(x, wd))
        row = {'phase': 'kernel', 'kernel': 'fp8_bmm', 'case': label,
               'shape': [E, M, K, N], 'group': K // gs.shape[1],
               'x': 'shared' if kind == 'gate' else 'per expert',
               'tile': {'tokens': token_tile(M), 'columns': FP8_ITEM_COLUMNS,
                        'items': E * -(-N // FP8_ITEM_COLUMNS) * -(-M // token_tile(M))},
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
               'nan_code_err_over_tol': nan_frac, 'ok': ok, 'tf32': False,
               'trap_err_over_tol': traps,
               'kernel_ms': time_ms(lambda: fp8_bmm(x, w8, gs)),
               'plain_ms': (eager_ms(lambda: plain(x, w8, gs)) if v3 else
                            time_ms(lambda: plain(x, w8, gs), **PLAIN_TIMING)),
               'library_ms': None,
               'library': 'none: no PyTorch call multiplies blocked-fp8 weights by a bf16 x',
               'dense_bf16_ms': time_ms(dense),
               'bound_ms': bound_ms, 'bound_by': bound_by, 'mbytes': nbytes / 1e6}
        emit(row)
        results.append(row)
        del out, ref
        if not ok:
            raise SystemExit(f'fp8_bmm disagrees with its plain version, or its check '
                             f'misses a trap: {row}')
    stacks.clear()
    torch.cuda.empty_cache()
    return results


# fp8_bmm at every kind of scale group the wrapper takes (group % 16 == 0 dividing K):
# groups that divide 128, that are multiples of it, and that are neither (48, 96, 192:
# their groups straddle the kernel's 128-row K stages), on 8 experts at K 1536, N 1024,
# gate and down, each held against the plain version with the next-group-scale trap
FP8_GROUPS = (16, 48, 64, 96, 192, 256)
FP8_GROUP_SHAPE = (8, 1536, 1024, 64)          # E, K, N, M
# the scales of the kernel's decode check: the smallest subnormal and below f32's
# normals, a checkpoint-like one, either side of 256, large, f32's largest (products
# overflow to inf) and a negative one
FP8_EDGE_SCALES = (2.0 ** -149, 1e-38, 1.5e-5, 255.99, 256.0, 1e4, 3e38, -1.5)


def fp8_groups_phase():
    """fp8_bmm at the scale groups of FP8_GROUPS, and its decode of every e4m3 code in
    every byte position of a word times each of FP8_EDGE_SCALES: x is a row of ones and
    each weight column holds one code at one K row (zeros elsewhere), so the output is
    the kernel's bf16 weight itself and must equal the plain version's exactly."""
    from lmdeploy_tpu_torch.ops.quant_bmm import fp8_bmm, fp8_bmm_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(SEED + 9)
    tol = KERNEL_TOL['fp8_bmm']
    results = []
    E, K, N, M = FP8_GROUP_SHAPE
    for group in FP8_GROUPS:
        w8, gs = _fp8_seeded(gen, E, K, N, group)
        for kind in ('gate', 'down'):
            x = torch.randn((M, K) if kind == 'gate' else (E, M, K), device='cuda',
                            generator=gen).bfloat16()
            out = fp8_bmm(x, w8, gs)
            ref = fp8_bmm_plain(x, w8, gs)
            err, rel, frac = compare(out, ref, tol)
            trap = compare(_fp8_trapped('next_group_scale')(x, w8, gs), ref, tol)[2]
            ok = bool(torch.isfinite(out).all()) and frac <= 1.0 and trap > 1.0
            row = {'phase': 'kernel', 'kernel': 'fp8_bmm', 'case': f'group{group}_{kind}',
                   'shape': [E, M, K, N], 'group': group, 'max_abs_err': err,
                   'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
                   'trap_err_over_tol': {'next_group_scale': trap}, 'ok': ok}
            emit(row)
            results.append(row)
            if not ok:
                raise SystemExit(f'fp8_bmm disagrees with its plain version at group '
                                 f'{group}, or its check misses the trap: {row}')
        del w8, gs
    n = torch.arange(4 * 256 * len(FP8_EDGE_SCALES), device='cuda')
    # column n: code (n // 4) % 256 (so byte n % 4 of its word), at K row (n // 3) % 32,
    # scale FP8_EDGE_SCALES[n // 1024]
    code, k = (n // 4) % 256, (n // 3) % 32
    w8 = torch.zeros((1, 32, n.numel()), dtype=torch.uint8, device='cuda')
    w8[0, k, n] = code.to(torch.uint8)
    w8 = w8.view(torch.float8_e4m3fn)
    scale = torch.tensor(FP8_EDGE_SCALES, dtype=torch.float32, device='cuda')[n // 1024]
    gs = scale.expand(1, 2, -1).contiguous()                   # group 16
    x = torch.ones((1, 32), dtype=torch.bfloat16, device='cuda')
    out, ref = fp8_bmm(x, w8, gs), fp8_bmm_plain(x, w8, gs)
    differ = int((out != ref).sum().item())
    row = {'phase': 'kernel', 'kernel': 'fp8_bmm', 'case': 'decode_all_codes_edge_scales',
           'shape': [1, 1, 32, n.numel()], 'group': 16, 'scales': FP8_EDGE_SCALES,
           'outputs_differing': differ, 'infinite_outputs': int(torch.isinf(ref).sum().item()),
           'ok': differ == 0}
    emit(row)
    results.append(row)
    if differ:
        raise SystemExit(f'fp8_bmm\'s decode differs from the plain version\'s: {row}')
    return results


# the decode kernel of each KV policy this slice adds, and the bytes its cache holds a
# token and kv head at head_dim D (codes of K and V, and f32 metadata)
KV_POLICIES = {8: 'paged_decode_int4', 42: 'paged_decode_turbo', 16: 'paged_decode_fp8'}
KV_TOKEN_BYTES = {'paged_decode_int4': lambda D: D + 16,        # 2 x D/2 codes + 4 f32
                  'paged_decode_turbo': lambda D: 3 * D // 4 + 12,  # D/2 + D/4 + 3 f32
                  'paged_decode_fp8': lambda D: 2 * D}
# numerical traps planted in each kernel's plain version by a change of the cache's
# bytes (ROADMAP section 3): the check, and the parity phase, must read each one
KV_TRAPS = {'paged_decode_int4': ('nibble_order_swapped', 'min_terms_dropped'),
            'paged_decode_turbo': ('qjl_term_dropped', 'v_codebook_magnitudes_swapped'),
            'paged_decode_fp8': ('bytes_read_as_e5m2',)}
# the e2e_llama31 decode shape: 63 rows of 1,024-1,087 tokens and one of 4,096-4,159
# in the 64-row bucket, the 4,224-token session's 33-page table
L31_SESSION = 4096 + 128
L31_W = L31_SESSION // 128
# the int4, TurboQuant and e4m3 decodes split each row's pages over blocks: their split
# lengths (tokens) swept at every case, each held against the plain version, and the
# module constant that sets each; the plain two passes (each split's partials, then the
# combine) carry the trap of splits summed without their weights e^(m_s - m), held at
# one split a page, where every row of more than one page has several
KV_SPLIT_SWEEP = (256, 512, 1024, 2048)
KV_SPLIT_CONST = {'paged_decode_int4': 'SPLIT_TOKENS_INT4',
                  'paged_decode_turbo': 'SPLIT_TOKENS_TURBO',
                  'paged_decode_fp8': 'SPLIT_TOKENS_NARROW'}


def _kv_decode_fns(kernel):
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    name = 'paged_decode_attention' + kernel[len('paged_decode'):]
    return getattr(pd, name), getattr(pd, name + '_plain', pd.paged_decode_attention_plain)


def _combine_without_alpha(parts, sinks, dtype):
    """``cp_combine`` with its trap planted: the partials (acc, m, l) summed without
    their weights e^(m_s - m)."""
    from lmdeploy_tpu_torch.ops.paged_decode import MASK_VALUE
    m_g = torch.stack([m for _, m, _ in parts]).amax(0)
    lsum = sum(p[2] for p in parts)
    if sinks is not None:
        lsum = lsum + torch.where(m_g > 0.5 * MASK_VALUE, torch.exp(sinks.float() - m_g),
                                  torch.zeros_like(m_g))
    acc = sum(p[0] for p in parts)
    return (acc / torch.where(lsum == 0, torch.ones_like(lsum), lsum)[..., None]).to(dtype)


def _split_plain_trapped(kernel, q, kv, tables, kv_lens, layer, scale, hkv, softcap,
                         window=None, sinks=None):
    """The int8 / int4 / TurboQuant / plain-layout (2-byte or e4m3 pages) kernel's two
    passes in plain PyTorch at one split a page, combined without the splits' weights."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    terms = {'paged_decode_int8': pd.int8_decode_terms,
             'paged_decode_int4': pd.int4_decode_terms,
             'paged_decode_turbo': pd.turbo_decode_terms}.get(kernel, pd.plain_decode_terms)
    s, pv = terms(q, kv, tables, layer, scale, hkv, softcap)
    W = tables.shape[1]
    parts = pd.split_partials_plain(s, kv_lens, pv, s.shape[-1] // W, W, window)
    return _combine_without_alpha(parts, sinks, q.dtype)


def _kv_trapped(trap: str, kv):
    """A copy of cache ``kv`` whose bytes plant ``trap`` in any reader: the int4 codes'
    nibbles swapped (dim 2j read from the high nibble); the int4 mins zeroed (the
    Σq·kmin score term and the rowsum(p·vmin) output term dropped); the TurboQuant QJL
    norms zeroed (the qjl·(q·sgn) score term dropped); every TurboQuant V code
    XOR 1 (codebook magnitudes 0.453 and 1.510 swapped within each sign); e4m3 bytes
    read as e5m2."""
    from lmdeploy_tpu_torch.ops.kv_quant import QuantKV4, QuantKVTurbo
    if trap == 'nibble_order_swapped':
        return QuantKV4((kv.data << 4) | (kv.data >> 4), kv.scale, kv.minv)
    if trap == 'min_terms_dropped':
        return QuantKV4(kv.data, kv.scale, torch.zeros_like(kv.minv))
    if trap == 'qjl_term_dropped':
        meta = kv.meta.clone()
        meta[..., 1, :] = 0
        return QuantKVTurbo(kv.data, meta)
    if trap == 'v_codebook_magnitudes_swapped':
        data = kv.data.clone()
        hd2 = kv.shape[-1] // 2
        data[..., hd2:] ^= 0x55
        return QuantKVTurbo(data, kv.meta)
    if trap == 'bytes_read_as_e5m2':
        return kv.view(torch.float8_e5m2)
    raise ValueError(trap)


def new_kv_cache(model, num_blocks: int, block_size: int, policy: int, device):
    """A zeroed cache of ``model``'s layers in ``policy``'s layout, as the engine
    allocates it."""
    from lmdeploy_tpu_torch.config import CacheConfig
    from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
    return CacheEngine(model, CacheConfig(block_size=block_size, num_gpu_blocks=num_blocks,
                                          quant_policy=policy), torch.device(device)).kv_cache


def kv_decode_cases():
    """decode_kv_phase's cases, (label, B, Hq, Hkv, D, lens, W, softcap, opts): lens
    marks padding rows -1, opts may give q's dtype, the kernels a case is for, and for
    the e4m3 decode a block size (default 128), a window and sinks (True: drawn with
    the case)."""
    rng = np.random.RandomState(SEED + 2)
    # the e2e_llama31 phases' decode shape (Llama-3.1-8B heads, G 4), with two of its
    # short rows inactive; llama2-7b heads (G 1) and TinyLlama heads (D 64, G 8) at
    # ragged lengths averaging ~384 with one inactive row and four padding rows
    # (marked -1), the first of them also with a softcap
    lens_e2e = np.concatenate([rng.randint(1024, 1088, size=63), rng.randint(4096, 4160, 1)])
    lens_e2e[[7, 40]] = 0
    lens64 = rng.randint(1, 768, size=64)
    lens64[5] = 0
    lens64[-4:] = -1
    # the other narrow paths of the int4 / TurboQuant kernels: f16 q at D 256 (two query
    # blocks of 8 heads), f32 q (the CUDA-core bodies), int4's D 192 and 80; 8 rows of
    # 130-199 tokens, one of 2,100, one inactive, six padding rows
    lens16 = np.concatenate([rng.randint(130, 200, size=8), [2100], [0], -np.ones(6, int)])
    quant = ('paged_decode_int4', 'paged_decode_turbo')
    fp8 = ('paged_decode_fp8',)
    # the e4m3 decode's other cases: gpt-oss-20b heads with sinks and its 128-token
    # window, f16 q, block sizes 16 (a window of 1,000 and sinks) and 8 (the CUDA-core
    # body), on the 16-row lengths
    lens_gpt = np.concatenate([rng.randint(129, 193, size=32), rng.randint(2049, 2113, 1),
                               -np.ones(31, int)])
    return [('e2e_shape_llama31', 64, 32, 8, 128, lens_e2e, L31_W, None, {}),
            ('bs64_7b_heads', 64, 32, 32, 128, lens64, 8, None, {}),
            ('bs64_7b_heads_softcap', 64, 32, 32, 128, lens64, 8, 30.0, {}),
            ('bs64_tinyllama_heads', 64, 32, 4, 64, lens64, 8, None, {}),
            ('d256_g16_f16', 16, 32, 2, 256, lens16, 17, None,
             {'dtype': torch.float16, 'kernels': quant}),
            ('d128_f32', 16, 32, 8, 128, lens16, 17, 30.0,
             {'dtype': torch.float32, 'kernels': quant + fp8}),
            ('d192_int4', 16, 16, 4, 192, lens16, 17, None,
             {'kernels': ('paged_decode_int4',)}),
            ('d80_int4', 16, 32, 8, 80, lens16, 17, None,
             {'kernels': ('paged_decode_int4',)}),
            ('gptoss_heads_window_sinks', 64, 64, 8, 64, lens_gpt, 17, None,
             {'kernels': fp8, 'window': 128, 'sinks': True}),
            ('d128_f16', 16, 32, 8, 128, lens16, 17, 30.0,
             {'dtype': torch.float16, 'kernels': fp8}),
            ('bs16_window_sinks', 16, 32, 8, 128, lens16, 132, None,
             {'kernels': fp8, 'block_size': 16, 'window': 1000, 'sinks': True}),
            ('bs8', 16, 32, 8, 128, lens16, 263, None, {'kernels': fp8, 'block_size': 8})]


def decode_kv_phase():
    """paged_decode_int4, paged_decode_turbo and paged_decode_fp8 against their plain
    versions, each cache filled through the port's fill_kv_cache from random bf16 K/V;
    the int4 and TurboQuant rows also sweep their split length and hold the plain two
    passes (and their combine trap)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    from lmdeploy_tpu_torch.ops.attention import fill_kv_cache
    from lmdeploy_tpu_torch.ops.kv_quant import hadamard_rotate
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = kv_decode_cases()
    results = {k: [] for k in KV_POLICIES.values()}
    for label, B, Hq, Hkv, D, lens, W, softcap, opts in cases:
        dtype = opts.get('dtype', torch.bfloat16)
        BS = opts.get('block_size', 128)
        NB = 1 + B * W
        perm = torch.randperm(NB - 1, device='cuda', generator=gen) + 1
        tables = perm[:B * W].reshape(B, W).int()
        kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
        pad_rows = kv_lens < 0
        tables[pad_rows] = 0
        kv_lens[pad_rows] = 1
        tables = tables.contiguous()
        q0 = torch.randn(B, Hq, D, device='cuda', generator=gen)
        model = ModelConfig(num_layers=2, num_attention_heads=Hq, num_key_value_heads=Hkv,
                            hidden_size=Hq * D, intermediate_size=128, vocab_size=128,
                            head_dim=D, dtype='bfloat16')
        slots = torch.arange(BS, NB * BS, device='cuda')
        kvs = [(torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16(),
                torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16())
               for _ in range(2)]
        scale, layer = D ** -0.5, 1
        # the e4m3 decode's window and sinks
        extra = {'window': opts['window']} if 'window' in opts else {}
        if opts.get('sinks'):
            extra['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
        lens_np = kv_lens.cpu().numpy().astype(np.int64)
        toks = (np.minimum(lens_np, extra['window']) if 'window' in extra else lens_np).sum()
        for policy, kernel in KV_POLICIES.items():
            if kernel not in opts.get('kernels', KV_POLICIES.values()):
                continue
            cache = new_kv_cache(model, NB, BS, policy, 'cuda')
            for lay, (k, v) in enumerate(kvs):
                fill_kv_cache(cache, k, v, slots, lay)
            # the TurboQuant kernel reads q rotated into the cache's domain
            q = (hadamard_rotate(q0) if kernel == 'paged_decode_turbo' else q0).to(dtype)
            wrapper, plain = _kv_decode_fns(kernel)

            def kern():
                return wrapper(q, cache, tables, kv_lens, layer, scale, Hkv,
                               logit_softcap=softcap, **extra)

            def plain_on(kv):
                return plain(q, kv, tables, kv_lens, layer, scale, Hkv, logit_softcap=softcap,
                             **extra)
            out, ref = kern(), plain_on(cache)
            torch.cuda.synchronize()
            tol = KERNEL_TOL[kernel]
            err, rel, frac = compare(out, ref, tol)
            zero_ok = bool((out[kv_lens == 0] == 0).all())
            traps = {t: compare(plain_on(_kv_trapped(t, cache)), ref, tol)[2]
                     for t in KV_TRAPS[kernel]}
            split = {}
            if kernel in KV_SPLIT_CONST:
                traps['combine_without_alpha'] = compare(_split_plain_trapped(
                    kernel, q, cache, tables, kv_lens, layer, scale, Hkv, softcap,
                    extra.get('window'), extra.get('sinks')), ref, tol)[2]
                two_pass = getattr(pd, _kv_decode_fns(kernel)[1].__name__.replace(
                    '_plain', '_split_plain'))
                const = KV_SPLIT_CONST[kernel]
                chosen = getattr(pd, const)
                tokens, splits = chosen, pd.page_splits(W, BS, chosen)
                if kernel == 'paged_decode_fp8':
                    path = plain_layout_path(D, dtype, cache.dtype)
                    tokens = pd.narrow_split_tokens(D, cache.dtype, B)
                    splits = pd.plain_layout_splits(D, cache.dtype, B, W, BS,
                                                    extra.get('window'))
                else:
                    path = ('tensor cores' if D in pd.MMA_QUANT_HEAD_DIMS
                            and dtype != torch.float32 else 'cuda cores')
                split = {'path': path, 'split_tokens': tokens, 'splits': splits,
                         'split_plain_err_over_tol': compare(two_pass(
                             q, cache, tables, kv_lens, layer, scale, Hkv,
                             logit_softcap=softcap, **extra), ref, tol)[2],
                         'split_tokens_ms': {}, 'split_tokens_err_over_tol': {}}
                for tokens in KV_SPLIT_SWEEP:
                    setattr(pd, const, tokens)
                    split['split_tokens_err_over_tol'][tokens] = compare(kern(), ref, tol)[2]
                    split['split_tokens_ms'][tokens] = time_ms(kern)
                setattr(pd, const, chosen)
            ok = (bool(torch.isfinite(out.float()).all()) and frac <= 1.0 and zero_ok
                  and min(traps.values()) > 1.0
                  and all(e <= 1.0 for e in split.get('split_tokens_err_over_tol', {}).values())
                  and split.get('split_plain_err_over_tol', 0.0) <= 1.0)
            # bytes this data needs: each row's K and V codes and metadata, q and out
            nbytes = toks * Hkv * KV_TOKEN_BYTES[kernel](D) + 2 * q.element_size() * B * Hq * D
            bound_ms, bound_by = bound(4 * Hq * D * toks, nbytes)
            row = {'phase': 'kernel', 'kernel': kernel, 'case': label, 'quant_policy': policy,
                   'shape': [B, Hq, Hkv, D, BS, W], 'softcap': softcap,
                   'window': extra.get('window'), 'sinks': 'sinks' in extra,
                   'dtype': str(dtype).split('.')[-1], **split,
                   'mean_kv_len': float(kv_lens.float().mean()), 'max_kv_len': int(lens.max()),
                   'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
                   'zero_rows_ok': zero_ok, 'trap_err_over_tol': traps, 'ok': ok,
                   'kernel_ms': time_ms(kern), 'plain_ms': time_ms(lambda: plain_on(cache),
                                                                    **PLAIN_TIMING),
                   'library_ms': None, 'bound_ms': bound_ms, 'bound_by': bound_by,
                   'kv_mbytes': nbytes / 1e6}
            emit(row)
            results[kernel].append(row)
            del cache
            if not ok:
                raise SystemExit(f'{kernel} disagrees with its plain version, or its check '
                                 f'misses a trap: {row}')
        del kvs
        torch.cuda.empty_cache()
    return results


# the quantized caches with pages under 16 slots: (quant_policy, its decode kernel) at
# block sizes 8 (a tensor-core warp's 16 rows on two pages) and 2 (on eight);
# Llama-3.1-8B heads, 16 rows
SMALL_PAGE_POLICIES = ((4, 'paged_decode_int8'), (8, 'paged_decode_int4'),
                       (42, 'paged_decode_turbo'))
SMALL_PAGE_BS = (8, 2)
# the Engine check's session: 2,304 tokens (9 x 256) make the 16- and 8-slot tables
# split each row at the same token boundaries for every policy (``page_splits``: 9
# splits of 256 tokens for int8, 3 of 768 for int4, 2 of 1,152 for TurboQuant), so
# both decodes add the same terms in the same order; at the default 2,176 int8's splits
# fall at 256 and 248 tokens, and a greedy choice on a near tie may go either way
SMALL_PAGE_SESSION = 9 * 256


def decode_small_pages_phase():
    """The int8, int4 and TurboQuant decodes over caches of block size 8 and 2, filled
    by the port's fill: paged_attention on the card must route the decode to the
    policy's kernel (one launch, counted by its wrapper) and match the policy's plain
    decode (TurboQuant: q rotated in, the output rotated back, as paged_attention does),
    and the kernel's wrapper, called on its own, must match the plain decode too; then
    an Engine at 8 slots a page for each policy (``_small_pages_engines``)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.ops import attention as att
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    from lmdeploy_tpu_torch.ops.attention import fill_kv_cache
    from lmdeploy_tpu_torch.ops.kv_quant import hadamard_rotate, hadamard_rotate_inv
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rng = np.random.RandomState(SEED + 4)
    B, Hq, Hkv, D = 16, 32, 8, 128
    lens = np.concatenate([rng.randint(1, 300, size=14), [1100], [0]])
    kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
    model = ModelConfig(num_layers=2, num_attention_heads=Hq, num_key_value_heads=Hkv,
                        hidden_size=Hq * D, intermediate_size=128, vocab_size=128,
                        head_dim=D, dtype='bfloat16')
    q = torch.randn(B, Hq, D, device='cuda', generator=gen).bfloat16()
    scale, layer = D ** -0.5, 1
    wrappers = {'paged_decode_int8': (pd.paged_decode_attention_int8,
                                      pd.paged_decode_attention_int8_plain),
                **{k: _kv_decode_fns(k) for k in ('paged_decode_int4', 'paged_decode_turbo')}}
    counters = _kernel_counters()
    rows = []
    for BS in SMALL_PAGE_BS:
        W = -(-int(lens.max()) // BS)
        NB = 1 + B * W
        tables = (torch.randperm(NB - 1, device='cuda', generator=gen) + 1)[:B * W]
        tables = tables.reshape(B, W).int().contiguous()
        slots = torch.arange(BS, NB * BS, device='cuda')
        kvs = [(torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16(),
                torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16())
               for _ in range(2)]
        for policy, kernel in SMALL_PAGE_POLICIES:
            cache = new_kv_cache(model, NB, BS, policy, 'cuda')
            for lay, (k, v) in enumerate(kvs):
                fill_kv_cache(cache, k, v, slots, lay)
            route = att.decode_route(cache)
            before = counters[kernel].launches
            out = att.paged_attention(q[:, None], cache, tables, kv_lens - 1,
                                      torch.ones(B, dtype=torch.int32, device='cuda'), scale,
                                      layer, Hkv)[:, 0]
            launched = counters[kernel].launches - before
            wrapper, plain = wrappers[kernel]
            qk = hadamard_rotate(q).to(q.dtype) if kernel == 'paged_decode_turbo' else q

            def kern():
                return wrapper(qk, cache, tables, kv_lens, layer, scale, Hkv)

            def plain_fn():
                return plain(qk, cache, tables, kv_lens, layer, scale, Hkv)
            ref = plain_fn()
            direct = kern()
            torch.cuda.synchronize()
            tol = KERNEL_TOL[kernel]
            err, rel, frac = compare(direct, ref, tol)
            if kernel == 'paged_decode_turbo':
                ref = hadamard_rotate_inv(ref).to(q.dtype)
            route_err, _, route_frac = compare(out, ref, tol)
            zero_ok = bool((direct[kv_lens == 0] == 0).all())
            ok = (route == 'kernel' and launched == 1 and frac <= 1.0 and route_frac <= 1.0
                  and zero_ok and bool(torch.isfinite(out.float()).all()))
            row = {'phase': 'small_pages', 'kernel': kernel, 'quant_policy': policy,
                   'block_size': BS, 'shape': [B, Hq, Hkv, D, BS, W], 'route': route,
                   'kernel_launches': launched, 'max_abs_err': err, 'max_rel_err': rel,
                   'err_over_tol': frac, 'route_max_abs_err': route_err,
                   'route_err_over_tol': route_frac, 'zero_rows_ok': zero_ok, 'tol': tol,
                   'kernel_ms': time_ms(kern), 'ok': ok}
            emit(row)
            rows.append(row)
            del cache
            if not ok:
                raise SystemExit(f'a decode over {BS}-slot pages of quant_policy {policy} did '
                                 f'not take its kernel or disagrees with its plain version: '
                                 f'{row}')
        del kvs, tables, slots
    torch.cuda.empty_cache()
    return rows + _small_pages_engines(counters)


def _small_pages_engines(counters):
    """An Engine of TinyLlama's width at 2 layers and one seeded set of weights, for each
    quantized policy at block size 16 and then 8: four requests (37-1,100 tokens), 16
    greedy tokens each, in a ``SMALL_PAGE_SESSION``-token session.  At 8 slots a page
    each decode step must launch the policy's kernel once a layer, and the greedy
    tokens must equal those at 16."""
    from lmdeploy_tpu_torch.models.llama import LlamaModel
    model = tinyllama_config(num_layers=2)
    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(3, 32000, size=n).tolist() for n in (37, 130, 300, 1100)]
    shared = {}
    init = LlamaModel.init_params

    def init_once(self, *args, **kwargs):
        if 'init' not in shared:
            shared['init'] = init(self, *args, **kwargs)
        return shared['init']
    rows = []
    for policy, kernel in SMALL_PAGE_POLICIES:
        tokens, launched = {}, {}
        for BS in (16, 8):
            with _swapped((LlamaModel, 'init_params', init_once)):
                engine = build_engine(model, 4, policy, session_len=SMALL_PAGE_SESSION,
                                      block_size=BS)
            # the wrapper's launches plus each decode graph's launches times its replays
            before = engine.model_agent.graphs.launch_totals()[0][counters[kernel].__name__]
            outs, _, _ = run_requests(engine, prompts, 16)
            launched[BS] = (engine.model_agent.graphs.launch_totals()[0][
                counters[kernel].__name__] - before)
            tokens[BS] = [list(o.token_ids) for o in outs]
            del engine, outs
            torch.cuda.empty_cache()
        ok = tokens[8] == tokens[16] and launched[8] >= 15 * model.num_layers
        row = {'phase': 'small_pages_engine', 'kernel': kernel, 'quant_policy': policy,
               'launches': launched, 'tokens_equal': tokens[8] == tokens[16], 'ok': ok}
        emit(row)
        rows.append(row)
        if not ok:
            raise SystemExit(f'an Engine with 8-slot pages of quant_policy {policy} did not '
                             f'decode on its kernel or its greedy tokens differ from 16 slots: '
                             f'{row}')
    shared.clear()
    return rows


# the context-parallel decode: the e2e_llama31_8b_cp2 cell's session (a 16,384-token
# prompt and 64 new tokens, 129 pages of 128) and its traps, each planted in the plain
# partials or the plain combine: every rank reading its stripe as if it were rank 0's
# slots, the sinks joined on each rank before the combine, the ranks' partials summed
# without their weights e^(m_r - m_g)
CP_SESSION = 16384 + 128
CP_W = CP_SESSION // 128
CP_TRAPS = ('rank_offset_ignored', 'sinks_on_each_rank', 'combine_without_alpha')


def _cp_plain(trap=None):
    """``paged_decode_attention_cp``'s function through the plain partials and the
    plain combine, with ``trap`` planted."""
    from lmdeploy_tpu_torch.ops.paged_decode import (MASK_VALUE, cp_combine,
                                                     paged_decode_cp_partial_plain)

    def attend(q, kv, tables, kv_lens, layer, scale, hkv, mesh, logit_softcap=None,
               window=None, sinks=None):
        BS = kv.shape[3]
        bsl = BS // kv.cp
        parts = []
        for r, stripe in enumerate(kv.stripes):
            off = 0 if trap == 'rank_offset_ignored' else r * bsl
            acc, m, lsum = paged_decode_cp_partial_plain(q, stripe, tables, kv_lens, layer,
                                                         scale, hkv, off, BS, logit_softcap,
                                                         window)
            if trap == 'sinks_on_each_rank' and sinks is not None:
                lsum = lsum + torch.where(m > 0.5 * MASK_VALUE,
                                          torch.exp(sinks.float() - m), torch.zeros_like(m))
            parts.append((acc, m, lsum))
        if trap != 'combine_without_alpha':
            return cp_combine(parts, None if trap == 'sinks_on_each_rank' else sinks, q.dtype)
        m_g = torch.stack([m for _, m, _ in parts]).amax(0)
        lsum = sum(p[2] for p in parts)
        if sinks is not None:
            lsum = lsum + torch.where(m_g > 0.5 * MASK_VALUE, torch.exp(sinks.float() - m_g),
                                      torch.zeros_like(m_g))
        acc = sum(p[0] for p in parts)
        return (acc / torch.where(lsum == 0, torch.ones_like(lsum), lsum)[..., None]).to(q.dtype)
    return attend


# the context-parallel partial's split length (local slots of a rank) swept at the e2e
# cell's decode shape with cp 2 and 4, each held against the plain version
CP_SPLIT_SWEEP = (256, 512, 1024, 2048)
CP_SWEEP_CASES = ('e2e_cp2', 'e2e_cp4')


def cp_decode_cases():
    """decode_cp_phase's cases, (label, cp, B, Hq, Hkv, D, lens, W, opts): lens marks
    padding rows -1, opts may give q's dtype, a window and sinks (True: drawn with the
    case); block size 128."""
    rng = np.random.RandomState(SEED + 3)
    # the e2e cell's decode bucket: 31 rows of 1,025-1,088 tokens and one of
    # 16,385-16,448 in the 32-row bucket, the session's 129-page table
    lens_e2e = np.concatenate([rng.randint(1025, 1089, size=31), rng.randint(16385, 16449, 1)])
    lens_gptoss = np.concatenate([rng.randint(129, 193, size=32), rng.randint(2049, 2113, 1),
                                  -np.ones(31, int)])
    lens16 = np.concatenate([rng.randint(130, 200, size=8), [2100], [0], -np.ones(6, int)])
    return [('e2e_cp2', 2, 32, 32, 8, 128, lens_e2e, CP_W, {}),
            ('e2e_cp4', 4, 32, 32, 8, 128, lens_e2e, CP_W, {}),
            ('gptoss_sliding_cp2', 2, 64, 64, 8, 64, lens_gptoss, 17,
             {'window': 128, 'sinks': True}),
            ('gptoss_full_cp2', 2, 64, 64, 8, 64, lens_gptoss, 17, {'sinks': True}),
            ('d64_f16_cp2', 2, 16, 32, 4, 64, lens16, 17, {'dtype': torch.float16}),
            ('d96_f32_cp2', 2, 16, 32, 32, 96, lens16, 17, {'dtype': torch.float32}),
            ('d256_f16_cp4', 4, 16, 8, 4, 256, lens16, 17,
             {'dtype': torch.float16, 'window': 300, 'sinks': True}),
            ('d256_f32_cp2', 2, 16, 8, 4, 256, lens16, 17, {'dtype': torch.float32})]


def decode_cp_phase():
    """paged_decode_cp (each rank's partials on the card, the ranks on one card) and its
    combine against the plain partials and combine, at the e2e_llama31_8b_cp2 decode
    shape with cp 2 and 4, gpt-oss-20b heads with sinks (window 128 and none) and D 64 /
    96 / 256 in f16 and f32; beside each, the single-rank paged_decode on the
    unsharded cache at the same shape, the planted traps, the partials' and the
    combine's times apart, the plain two passes of each rank's split, and each rank's
    partials where it holds no slot of a row's window (exactly (0, MASK_VALUE, 0)); at
    the e2e shapes the split length swept."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    from lmdeploy_tpu_torch.ops.paged_decode import (MASK_VALUE, cp_combine, cp_local_slots,
                                                     paged_decode_attention,
                                                     paged_decode_attention_cp,
                                                     paged_decode_cp_partial,
                                                     paged_decode_cp_partial_split_plain)
    from lmdeploy_tpu_torch.parallel.mesh import StripedKV, build_mesh
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    BS = 128
    cases = cp_decode_cases()
    results = []
    for label, cp, B, Hq, Hkv, D, lens, W, opts in cases:
        opts = dict(opts)
        dtype = opts.pop('dtype', torch.bfloat16)
        q, cache, tables, kv_lens = _decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens,
                                                   dtype=dtype)
        if opts.get('sinks'):
            opts['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
        mesh = build_mesh(cp=cp, devices=['cuda:0'] * cp)
        kv = StripedKV.from_reference_layout(cache, mesh.cp_devices)
        scale, layer = D ** -0.5, 1
        bsl = BS // cp
        window = opts.get('window')

        def kern():
            return paged_decode_attention_cp(q, kv, tables, kv_lens, layer, scale, Hkv, mesh,
                                             **opts)

        def plain(trap=None):
            return _cp_plain(trap)(q, kv, tables, kv_lens, layer, scale, Hkv, mesh, **opts)

        def single():
            return paged_decode_attention(q, cache, tables, kv_lens, layer, scale, Hkv,
                                          **opts)

        def partials():
            return [paged_decode_cp_partial(q, stripe, tables, kv_lens, layer, scale, Hkv,
                                            r * bsl, BS, window=window)
                    for r, stripe in enumerate(kv.stripes)]
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        tol = KERNEL_TOL['paged_decode_cp']
        err, rel, frac = compare(out, ref, tol)
        single_frac = compare(single(), ref, tol)[2]
        zero_ok = bool((out[kv_lens == 0] == 0).all())
        traps = {t: compare(plain(t), ref, tol)[2] for t in CP_TRAPS
                 if t != 'sinks_on_each_rank' or opts.get('sinks') is not None}
        # each rank's partials where it holds no slot of a row's window: (0, MASK_VALUE, 0)
        parts = partials()
        lens_l = kv_lens.long()
        ws = (lens_l - window).clamp(min=0) if window else torch.zeros_like(lens_l)
        empty_rows = []
        for r, (acc, m, lsum) in enumerate(parts):
            empty = (cp_local_slots(lens_l, r * bsl, BS, bsl)
                     <= cp_local_slots(ws, r * bsl, BS, bsl))
            empty_rows.append(int(empty.sum()))
            zero_ok = zero_ok and bool((m[empty] == MASK_VALUE).all()) \
                and bool((lsum[empty] == 0).all()) and bool((acc[empty] == 0).all())
        split_plain = cp_combine(
            [paged_decode_cp_partial_split_plain(q, stripe, tables, kv_lens, layer, scale,
                                                 Hkv, r * bsl, BS, window=window)
             for r, stripe in enumerate(kv.stripes)], opts.get('sinks'), q.dtype)
        split = {'path': ('tensor cores' if D in pd.CP_MMA_HEAD_DIMS
                          and dtype != torch.float32 else 'cuda cores'),
                 'splits': pd.cp_splits(W, bsl, D, dtype),
                 'split_plain_err_over_tol': compare(split_plain, ref, tol)[2]}
        ok = (bool(torch.isfinite(out.float()).all()) and frac <= 1.0 and zero_ok
              and single_frac <= 1.0 and min(traps.values()) > 1.0
              and split['split_plain_err_over_tol'] <= 1.0)
        # bytes this data needs: each rank's in-window K and V rows (the ranks together
        # read each row's once), q and out
        lens_np = kv_lens.cpu().numpy().astype(np.int64)
        win = window or 0
        toks = np.minimum(lens_np, win) if win else lens_np
        el = cache.element_size()
        nbytes = toks.sum() * Hkv * D * 2 * el + el * (2 * B * Hq * D)
        bound_ms, bound_by = bound(4 * Hq * D * toks.sum(), nbytes)
        row = {'phase': 'kernel', 'kernel': 'paged_decode_cp', 'case': label, 'cp': cp,
               'shape': [B, Hq, Hkv, D, BS, W], 'dtype': str(dtype).split('.')[-1],
               'window': win or None, 'sinks': opts.get('sinks') is not None, **split,
               'mean_kv_len': float(lens_np.mean()), 'max_kv_len': int(lens_np.max()),
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
               'single_rank_err_over_tol': single_frac, 'zero_rows_ok': zero_ok,
               'empty_rank_rows': empty_rows, 'trap_err_over_tol': traps, 'ok': ok,
               'kernel_ms': time_ms(kern), 'plain_ms': time_ms(plain, **PLAIN_TIMING),
               'partials_ms': time_ms(partials),
               'combine_ms': time_ms(lambda: cp_combine(parts, opts.get('sinks'), q.dtype)),
               'single_rank_paged_decode_ms': time_ms(single),
               'library_ms': None, 'bound_ms': bound_ms, 'bound_by': bound_by,
               'kv_mbytes': nbytes / 1e6}
        if label in CP_SWEEP_CASES:
            chosen = pd.SPLIT_TOKENS_CP
            # each length timed twice, in turns
            row['split_tokens_ms'] = {t: [] for t in CP_SPLIT_SWEEP}
            row['split_tokens_err_over_tol'] = {}
            for _ in range(2):
                for tokens in CP_SPLIT_SWEEP:
                    pd.SPLIT_TOKENS_CP = tokens
                    row['split_tokens_err_over_tol'][tokens] = compare(kern(), ref, tol)[2]
                    row['split_tokens_ms'][tokens].append(time_ms(kern))
            pd.SPLIT_TOKENS_CP = chosen
            row['ok'] = ok = ok and max(row['split_tokens_err_over_tol'].values()) <= 1.0
        emit(row)
        results.append(row)
        del q, cache, kv, parts
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f'paged_decode_cp disagrees with its plain version, or its '
                             f'check misses a trap: {row}')
    return results


# the int8 (quant_policy 4) and int4 (8) decodes at MLA's latent head: one kv head of
# 576 (the V rows the latent and 64 zeros) under DeepSeek-V2-Lite's 16 and V3's 128
# query heads, at the e2e_deepseek_v2_lite_fp8 cell's decode shape
MLA_QUANT = {4: 'paged_decode_int8', 8: 'paged_decode_int4'}
MLA_TOKEN_BYTES = {'paged_decode_int8': lambda D: 2 * D + 8,     # 2 x D codes + 2 f32
                   'paged_decode_int4': lambda D: D + 16}        # 2 x D/2 codes + 4 f32


def decode_mla_quant_phase():
    """paged_decode_int8 and paged_decode_int4 at D 576 against their plain versions,
    each cache filled through the port's fill_kv_cache from random bf16 latents; the
    int4 rows with its planted traps."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.ops.attention import fill_kv_cache
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rng = np.random.RandomState(SEED + 4)
    BS, D, L = 128, 576, 2
    lens = np.concatenate([rng.randint(1025, 1089, size=63), rng.randint(4097, 4161, 1)])
    lens[[9, 33]] = 0
    W = (4096 + 128 + 127) // 128
    B = len(lens)
    NB = 1 + B * W
    perm = torch.randperm(NB - 1, device='cuda', generator=gen) + 1
    tables = perm[:B * W].reshape(B, W).int().contiguous()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
    slots = torch.arange(BS, NB * BS, device='cuda')
    results = {k: [] for k in MLA_QUANT.values()}
    for policy, kernel in MLA_QUANT.items():
        model = ModelConfig(num_layers=L, num_attention_heads=16, num_key_value_heads=1,
                            hidden_size=2048, intermediate_size=128, vocab_size=128,
                            head_dim=D, dtype='bfloat16')
        cache = new_kv_cache(model, NB, BS, policy, 'cuda')
        for layer in range(L):
            k = torch.randn(len(slots), 1, D, device='cuda', generator=gen).bfloat16()
            v = torch.cat([k[..., :512], torch.zeros_like(k[..., 512:])], -1)
            fill_kv_cache(cache, k, v, slots, layer)
            del k, v
        wrapper, plain = _kv_decode_fns(kernel)
        for label, Hq in (('mla_v2_lite', 16), ('mla_v3', 128)):
            q = torch.randn(B, Hq, D, device='cuda', generator=gen).bfloat16()
            scale, layer = 192 ** -0.5, 1

            def kern():
                return wrapper(q, cache, tables, kv_lens, layer, scale, 1)

            def plain_on(kv):
                return plain(q, kv, tables, kv_lens, layer, scale, 1)
            out, ref = kern(), plain_on(cache)
            torch.cuda.synchronize()
            tol = KERNEL_TOL[kernel]
            err, rel, frac = compare(out, ref, tol)
            zero_ok = bool((out[kv_lens == 0] == 0).all())
            traps = {t: compare(plain_on(_kv_trapped(t, cache)), ref, tol)[2]
                     for t in KV_TRAPS.get(kernel, ())}
            ok = (bool(torch.isfinite(out.float()).all()) and frac <= 1.0 and zero_ok
                  and all(v > 1.0 for v in traps.values()))
            toks = int(lens.sum())
            nbytes = toks * MLA_TOKEN_BYTES[kernel](D) + 2 * (2 * B * Hq * D)
            bound_ms, bound_by = bound(4 * Hq * D * toks, nbytes)
            row = {'phase': 'kernel', 'kernel': kernel, 'case': label,
                   'quant_policy': policy, 'shape': [B, Hq, 1, D, BS, W],
                   'mean_kv_len': float(kv_lens.float().mean()), 'max_kv_len': int(lens.max()),
                   'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
                   'zero_rows_ok': zero_ok, 'trap_err_over_tol': traps, 'ok': ok,
                   'kernel_ms': time_ms(kern),
                   'plain_ms': time_ms(lambda: plain_on(cache), **PLAIN_TIMING),
                   'library_ms': None, 'bound_ms': bound_ms, 'bound_by': bound_by,
                   'kv_mbytes': nbytes / 1e6}
            emit(row)
            results[kernel].append(row)
            del q
            if not ok:
                raise SystemExit(f'{kernel} at D 576 disagrees with its plain version, or '
                                 f'its check misses a trap: {row}')
        del cache
        torch.cuda.empty_cache()
    return results


# -- phase 5 and 6 -------------------------------------------------------------------
def build_engine(model, max_batch: int, quant_policy: int = 0, session_len: int = 2048 + 128,
                 mesh=None, block_size: int = 128, eager_mode: bool = False,
                 num_blocks: int = 0, speculative_config=None, tokenizer=None, adapters=None,
                 cache_fraction: float = 0.5):
    from lmdeploy_tpu_torch.config import (CacheConfig, EngineConfigBundle, MiscConfig,
                                           SchedulerConfig)
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import QuantPolicy, TpuEngineConfig
    bundle = EngineConfigBundle(
        model=model,
        cache=CacheConfig(block_size=block_size, num_gpu_blocks=num_blocks,
                          cache_max_entry_count=cache_fraction,
                          max_prefill_token_num=8192,
                          quant_policy=QuantPolicy(quant_policy)),
        scheduler=SchedulerConfig(max_batch_size=max_batch, max_session_len=session_len,
                                  max_prefill_token_num=8192, max_prefill_batch=16),
        misc=MiscConfig(empty_init=True, eager_mode=eager_mode))
    return Engine(None, TpuEngineConfig(quant_policy=quant_policy, eager_mode=eager_mode,
                                        adapters=adapters),
                  configs=bundle, mesh=mesh, speculative_config=speculative_config,
                  tokenizer=tokenizer)


def run_requests(engine, prompts, new_tokens, sampled=(), logprobs: int = 0,
                 logprob_rows=None):
    """Serve the prompts at once, greedy but for the indices in ``sampled``, which
    draw seeded samples (top-k 40, top-p 0.95, temperature 0.8, seed 1000 + index),
    each token with the ``logprobs`` most likely beside it (only the requests of
    ``logprob_rows`` where it is given)."""
    from lmdeploy_tpu_torch.messages import GenerationConfig
    inst = engine.create_instance()

    def gen(i):
        extra = (dict(do_sample=True, top_k=40, top_p=0.95, temperature=0.8,
                      random_seed=1000 + i) if i in sampled else {})
        lp = logprobs if logprob_rows is None or i in logprob_rows else 0
        return GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True,
                                logprobs=lp, **extra)

    async def go():
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen(i))
                                      for i, p in enumerate(prompts)])
    t0 = time.time()
    outs = asyncio.run(go())
    torch.cuda.synchronize()
    return outs, t0, time.time()


def serving_numbers(run) -> dict:
    """TTFT (arrival to first token), decode tok/s (tokens after each request's
    first, over the time from the last first token to the end) and output tok/s."""
    m = [o.req_metrics for o in run['outs']]
    ttft = sorted(x.first_token_time - x.arrival_time for x in m)
    t_first_all = max(x.first_token_time for x in m)
    tokens = [o.token_ids for o in run['outs']]
    return {'ttft_ms': {'min': ttft[0] * 1e3, 'p50': ttft[len(ttft) // 2] * 1e3,
                        'max': ttft[-1] * 1e3},
            'decode_tok_s': sum(len(t) - 1 for t in tokens) / (run['t1'] - t_first_all),
            'output_tok_s': sum(len(t) for t in tokens) / (run['t1'] - run['t0']),
            'wall_s': run['t1'] - run['t0']}


def _kernel_counters():
    from lmdeploy_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                     paged_decode_attention_int8,
                                                     paged_decode_cp_partial)
    from lmdeploy_tpu_torch.ops.quant_bmm import fp8_bmm, mxfp4_bmm
    from lmdeploy_tpu_torch.ops.quant_matmul import (w4a16_matmul, w4a16_matmul_gd,
                                                     w4a16_matmul_szc)
    return {'flash_prefill': flash_prefill_attention, 'paged_decode': paged_decode_attention,
            'paged_decode_int8': paged_decode_attention_int8, 'w4a16_gemm': w4a16_matmul_gd,
            'w4a16_szc': w4a16_matmul_szc, 'w4a16_unprepared': w4a16_matmul,
            'mxfp4_bmm': mxfp4_bmm, 'fp8_bmm': fp8_bmm, 'paged_decode_cp': paged_decode_cp_partial,
            **{kernel: _kv_decode_fns(kernel)[0] for kernel in KV_POLICIES.values()}}


def _row_recorders():
    """{kernel: (module, attr, rows of the call)} for the GEMM kernels, whose launch
    shape depends on the decode bucket: the e2e phases record the M of every launch."""
    from lmdeploy_tpu_torch.nn import linear
    from lmdeploy_tpu_torch.ops import moe
    return {'w4a16_gemm': (linear, 'w4a16_matmul_gd', lambda x: x.shape[0]),
            'w4a16_szc': (linear, 'w4a16_matmul_szc', lambda x: x.shape[0]),
            'w4a16_unprepared': (linear, 'w4a16_matmul', lambda x: x.shape[0]),
            'mxfp4_bmm': (moe, 'mxfp4_bmm', lambda x: x.shape[-2]),
            'fp8_bmm': (moe, 'fp8_bmm', lambda x: x.shape[-2])}


def _built(model, max_batch, quant_policy, long_len, cp, shared, env, eager_mode=False,
           num_blocks: int = 0, **engine_kw):
    """An engine of the cell (``shared`` carries the raw seeded weights from one engine
    to the next of the same model; each engine fuses and prepares them itself; ``env``
    holds the engine switches set while it is built; ``engine_kw``: ``build_engine``'s
    ``tokenizer``, ``adapters`` and ``cache_fraction``) and its build seconds."""
    from lmdeploy_tpu_torch.models.llama import LlamaModel
    from lmdeploy_tpu_torch.parallel.mesh import build_mesh
    t_build = time.perf_counter()
    init = LlamaModel.init_params

    def init_once(self, *args, **kwargs):
        if 'init' not in shared:
            shared['init'] = init(self, *args, **kwargs)
        return shared['init']
    swaps = [(LlamaModel, 'init_params', init_once)] if shared is not None else []
    saved_env = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        with _swapped(*swaps):
            engine = build_engine(model, max_batch, quant_policy,
                                  session_len=max(2048, long_len) + 128,
                                  mesh=build_mesh(cp=cp, devices=['cuda:0'] * cp)
                                  if cp > 1 else None, eager_mode=eager_mode,
                                  num_blocks=num_blocks, **engine_kw)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return engine, time.perf_counter() - t_build


def _warmed(engine, n_requests: int) -> dict:
    """``ModelAgent.warmup`` at the cell's batch bucket: its graph numbers."""
    from lmdeploy_tpu_torch.config import bucketize
    agent = engine.model_agent
    # a capture's private pool cannot take the blocks the allocator caches (a seeded
    # tree's f32 draws leave tens of GB of them at V3's widths)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    agent.warmup(batch_sizes=[min(n_requests, agent.max_batch)])
    torch.cuda.synchronize()
    return {'bucket': bucketize(min(n_requests, agent.max_batch), agent.batch_buckets),
            'warmup_s': time.perf_counter() - t0, **agent.graphs.stats()}


def e2e_phase(name: str, model, max_batch: int, quant_policy: int, n_short: int,
              need_per_step, card: str, short_len: int = 128, long_len: int = 2048,
              exact: bool = False, shared: dict = None,
              env: dict = None, forbid=(), runs: int = 2, new_tokens: int = 64,
              trace: bool = True, cp: int = 1, combined: dict = None,
              graphs_check: dict = None, prompts=None, cache_blocks: int = 0,
              engine_check=None) -> dict:
    """Drive the Engine ``runs`` times on the same requests (launch counts from the
    first run, card numbers from the last; every run must give the first one's greedy
    tokens, so with ``runs=1`` nothing is compared, and the card numbers come from
    that one run, which only ``warmup`` preceded), then, with ``trace``, a traced run:
    ``n_short`` prompts of ``short_len`` tokens and one of ``long_len``,
    ``new_tokens`` greedy tokens each (or the lists of token ids ``prompts``, the
    longest at most ``long_len``), over a cache of ``cache_blocks`` blocks (0: sized from
    free memory).  The engine decodes by
    replaying CUDA graphs (the default), warmed up at the cell's batch bucket first;
    any decode run that does not replay fails the phase.  ``need_per_step`` maps
    each kernel of the path to its launches per (fresh prefill, decode[, prefill of
    at most 256 rows]) step; with ``exact`` the first run must launch exactly that
    many, else at least; each kernel of ``forbid`` must not launch at all.  A graph's
    launches are counted at its capture and multiplied by its replays.
    ``shared`` carries the raw seeded weights from one phase's engine to the next one
    of the same model; each engine fuses and prepares them itself.  ``env`` holds the
    engine switches (``LMDEPLOY_TPU_*``) set while the engine is built.  ``cp`` > 1
    serves the cell with its KV striped over that many context-parallel ranks, all on
    the one card.  ``combined`` maps each kernel whose calls split a row's pages to
    the share of its launches that also launch the combine (``.combines``): all of
    them, or the full-attention layers' half of gpt-oss's, whose sliding layers' window
    fits one split.  With ``graphs_check`` (its keyword arguments, ``{}`` for the full
    check), ``decode_graphs_phase`` follows on the same engine.  ``engine_check(engine)``,
    if given, runs on the engine after the runs and returns a row whose ``ok`` the phase
    holds.  Returns the phase's row."""
    from lmdeploy_tpu_torch.config import bucketize
    if prompts is None:
        rng = np.random.RandomState(SEED)
        prompts = [rng.randint(3, 32000, size=short_len).tolist() for _ in range(n_short)]
        prompts.append(rng.randint(3, 32000, size=long_len).tolist())
    reuse = shared is not None and 'init' in shared
    if graphs_check is not None and shared is None:
        shared = {}                     # the eager engine of the check takes the weights
    engine, build_s = _built(model, max_batch, quant_policy, long_len, cp, shared, env,
                             num_blocks=cache_blocks)
    agent = engine.model_agent
    warm = _warmed(engine, len(prompts))
    seconds = {}
    steps = {'prefill': 0, 'fresh_prefill': 0, 'small_prefill': 0, 'decode': 0,
             'decode_runs': 0, 'dispatched_while_busy': 0}
    prefill, decode_run = agent.prefill, agent.decode_run
    last = {}

    def counted_prefill(chunks):
        steps['prefill'] += 1
        # a step whose every chunk starts its prompt takes flash_prefill; a step with a
        # continuation chunk of a prompt longer than the token budget takes the dense
        # gathered path (ops/attention.py)
        steps['fresh_prefill'] += all(c.start == 0 for c in chunks)
        # the rows of the step's padded batch (ModelAgent._run): at most 256 take the
        # W4A16 kernels, more the dense route
        rows = (bucketize(len(chunks), agent.batch_buckets)
                * bucketize(max(c.length for c in chunks), agent.chunk_buckets))
        steps['small_prefill'] += rows <= 256
        return prefill(chunks)

    def counted_decode_run(num_rows, k=None, *args):
        steps['decode'] += k or agent.decode_run_steps
        steps['decode_runs'] += 1
        # the run before is still on the card: the host did not wait for it
        prev = last.get('run')
        steps['dispatched_while_busy'] += prev is not None and not prev._event.query()
        last['run'] = decode_run(num_rows, k, *args)
        return last['run']
    agent.prefill, agent.decode_run = counted_prefill, counted_decode_run

    counters = _kernel_counters()
    rows = {n: collections.Counter() for n in _row_recorders()}

    def recorder(name, fn, rows_of):
        def seen(x, *args):
            if not agent.graphs.capturing:       # a warm pass or a capture is no run
                rows[name][rows_of(x)] += 1
            return fn(x, *args)
        return seen
    record = [(m, a, recorder(n, getattr(m, a), f)) for n, (m, a, f) in _row_recorders().items()]
    results = []
    t_runs = time.perf_counter()
    for i in range(runs):
        steps.update({k: 0 for k in steps})
        last.clear()
        for fn in counters.values():
            fn.launches = 0
            if hasattr(fn, 'combines'):
                fn.combines = 0
        agent.graphs.reset_counts()
        pipelined, overlaps = engine._pipelined_runs, engine._overlap_dispatches
        torch.cuda.reset_peak_memory_stats()
        # the first run also records the rows of every GEMM-kernel call of the path
        with _swapped(*record if i == 0 else []):
            outs, t0, t1 = run_requests(engine, prompts, new_tokens)
        launches, combines = agent.graphs.launch_totals()
        if i == 0:
            # the rows of the GEMM launches inside graphs: the run's batch bucket
            for run in agent.graphs.runs.values():
                for n, fn in counters.items():
                    if n in rows and run.replays:
                        rows[n][run.key[1]] += run.launches.get(fn.__name__, 0) * run.replays
        results.append({'tokens': [o.token_ids for o in outs], 'outs': outs, 't0': t0,
                        't1': t1, 'steps': dict(steps), 'graphs': agent.graphs.stats(),
                        'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
                        'pipelined_runs': engine._pipelined_runs - pipelined,
                        'overlap_dispatches': engine._overlap_dispatches - overlaps,
                        'launches': {n: launches[fn.__name__] for n, fn in counters.items()},
                        'combines': {n: combines[fn.__name__] for n, fn in counters.items()
                                     if hasattr(fn, 'combines')}})
    seconds['runs'] = time.perf_counter() - t_runs
    checked = engine_check(engine) if engine_check is not None else None
    t_trace = time.perf_counter()
    trace_row = profile_phase(name, engine, prompts, new_tokens) if trace else None
    seconds['trace'] = time.perf_counter() - t_trace
    check = (decode_graphs_phase(name, engine, prompts, new_tokens, card,
                                 lambda: _built(model, max_batch, quant_policy, long_len,
                                                cp, shared, env, eager_mode=True,
                                                num_blocks=cache_blocks)[0],
                                 trace_row, **graphs_check)
             if graphs_check is not None else None)
    first, last_run = results[0], results[-1]
    num_blocks = agent.num_blocks
    cp_devices = [str(d) for d in agent.mesh.cp_devices] if agent.mesh is not None else None
    agent.prefill, agent.decode_run = prefill, decode_run
    engine.close()
    del engine, agent, prefill, decode_run, counted_prefill, counted_decode_run
    lengths_ok = all(len(t) == new_tokens for r in results for t in r['tokens'])
    finite = all(np.isfinite(lp[tok].logprob)
                 for o in first['outs'] for lp, tok in zip(o.logprobs, o.token_ids))
    deterministic = all(r['tokens'] == first['tokens'] for r in results)
    # every decode run of every run replayed a graph
    replayed = all(r['graphs']['eager_runs'] == 0 and
                   r['graphs']['replays'] == r['steps']['decode_runs'] > 0 for r in results)
    st = first['steps']
    need = {n: per[0] * st['fresh_prefill'] + per[1] * st['decode']
            + (per[2] * st['small_prefill'] if len(per) > 2 else 0)
            for n, per in need_per_step.items()}
    launches_ok = all((first['launches'][n] == need[n] if exact else
                       first['launches'][n] >= need[n]) and need[n] > 0 for n in need)
    launches_ok = launches_ok and all(first['launches'][n] == 0 for n in forbid)
    launches_ok = launches_ok and all(first['combines'][n] == share * first['launches'][n]
                                      for n, share in (combined or {}).items())
    row = {'phase': name, 'model': model_label(model, quant_policy), 'card': card,
           'cp': cp, 'cp_devices': cp_devices,
           'requests': len(prompts), 'new_tokens': new_tokens, 'runs': runs,
           'engine_build_s': build_s, 'weights_reused': reuse, 'quant_policy': quant_policy,
           'env': env or {}, 'lengths_ok': lengths_ok, 'logprobs_finite': finite,
           'deterministic': deterministic, 'replayed': replayed, 'warmup': warm,
           'seconds': seconds,
           'graphs_by_run': [r['graphs'] for r in results],
           'pipelined_runs': [r['pipelined_runs'] for r in results],
           'overlap_dispatches': [r['overlap_dispatches'] for r in results],
           'steps': first['steps'],
           'launches': first['launches'], 'combines': first['combines'],
           'launches_needed': need,
           'launches_forbidden': list(forbid), 'launches_ok': launches_ok,
           'rows_by_kernel': {n: dict(c) for n, c in rows.items() if c},
           'num_blocks': num_blocks,
           # the allocator's peak in each run (weights, cache, graph pool and the
           # prefill's transients, the gathered path's f32 scores included)
           'peak_allocated_bytes': [r['peak_allocated_bytes'] for r in results],
           'busy_share': trace_row['device_busy_share'] if trace_row else None,
           # card numbers from the last run (cuBLAS and allocator warmed by the first)
           **serving_numbers(last_run)}
    emit(row)
    del results, first, last_run
    gc.collect()
    torch.cuda.empty_cache()          # the next engine's block budget sees free memory
    if not (lengths_ok and finite and deterministic and replayed and launches_ok):
        raise SystemExit(f'{name} phase failed: {row}')
    if checked is not None and not checked['ok']:
        raise SystemExit(f'the engine check of {name} failed: {checked}')
    if check is not None and not check['ok']:
        raise SystemExit(f'decode_graphs of {name} failed: {check}')
    return row


def decode_graphs_phase(name, engine, prompts, new_tokens, card, build_eager,
                        graphs_trace, traffic=('greedy', 'sampled'),
                        trace: bool = True) -> dict:
    """The cell's requests on its graph engine and on an engine of the same weights
    with ``eager_mode=True``, in turns, for each kind of ``traffic``: all greedy
    (eager, graphs), then every other request seeded-sampled (graphs, eager); then,
    with ``trace``, one traced eager run (the graph engine's busy share is
    ``graphs_trace``, the e2e phase's traced run of the same requests).  Tokens must
    be equal between the modes, the graph engine must replay every decode run and the
    eager one none; prints each mode's decode tok/s, TTFT p50 and busy share, and the
    seconds each part took."""
    t0 = time.perf_counter()
    eager = build_eager()
    _warmed(eager, len(prompts))              # builds nothing: no capture in eager mode
    seconds = {'eager_build': time.perf_counter() - t0}
    engines = {'eager': eager, 'graphs': engine}
    sampled = set(range(0, len(prompts), 2))
    tokens = {kind: {} for kind in traffic}
    numbers = collections.defaultdict(list)
    orders = {'greedy': ('eager', 'graphs'), 'sampled': ('graphs', 'eager')}
    for kind in traffic:
        for mode in orders[kind]:
            engines[mode].model_agent.graphs.reset_counts()
            outs, t0, t1 = run_requests(engines[mode], prompts, new_tokens,
                                        sampled=sampled if kind == 'sampled' else ())
            tokens[kind][mode] = [o.token_ids for o in outs]
            g = engines[mode].model_agent.graphs.stats()
            numbers[mode].append({'traffic': kind, **serving_numbers(
                {'outs': outs, 't0': t0, 't1': t1}), 'replays': g['replays'],
                'eager_runs': g['eager_runs']})
    eager_trace = None
    if trace:
        t0 = time.perf_counter()
        eager_trace = profile_phase(f'{name}_eager', eager, prompts, new_tokens)
        seconds['eager_trace'] = time.perf_counter() - t0
    eager.close()
    del eager, engines
    gc.collect()
    torch.cuda.empty_cache()
    equal = {t: tokens[t]['eager'] == tokens[t]['graphs'] for t in tokens}
    graphs_replayed = all(n['eager_runs'] == 0 and n['replays'] > 0 for n in numbers['graphs'])
    eager_eager = all(n['replays'] == 0 and n['eager_runs'] > 0 for n in numbers['eager'])
    row = {'phase': 'decode_graphs', 'of': name, 'card': card,
           **{f'{kind}_equal': equal[kind] for kind in traffic},
           'graphs_replayed': graphs_replayed, 'eager_ran_eagerly': eager_eager,
           'runs': dict(numbers),
           'decode_tok_s': {m: [n['decode_tok_s'] for n in numbers[m]] for m in numbers},
           'ttft_p50_ms': {m: [n['ttft_ms']['p50'] for n in numbers[m]] for m in numbers},
           'busy_share': {'eager': eager_trace and eager_trace['device_busy_share'],
                          'graphs': graphs_trace and graphs_trace['device_busy_share']},
           'seconds': seconds}
    row['ok'] = all(equal.values()) and graphs_replayed and eager_eager
    emit(row)
    return row


KV_LABELS = {0: 'bf16 KV', 4: 'int8 KV', 8: 'int4 KV', 16: 'fp8-e4m3 KV',
             42: 'TurboQuant k4v2 KV'}


def model_label(model, policy: int = 0) -> str:
    if model.hf_arch.endswith('ForRewardModel'):
        name = {8192: 'qwen2.5-math-rm-72b', 4096: 'internlm2-7b-reward'}.get(
            model.hidden_size, 'reward model')
        return (f'{name} geometry, {model.num_layers} layers, bf16 + its score head + '
                f'{KV_LABELS[policy]}, random seeded weights')
    if model.hf_arch in ('Qwen3NextForCausalLM', 'Qwen3_5MoeForConditionalGeneration'):
        return (f'qwen3-next-80b-a3b geometry, {model.num_layers} layers (gated-DeltaNet and '
                f'gated full attention, {model.num_experts} experts), bf16 experts + '
                f'{KV_LABELS[policy]}, random seeded weights')
    if model.is_mla:
        name = {2048: 'deepseek-v2-lite', 7168: 'deepseek-v3'}.get(model.hidden_size,
                                                                 'deepseek')
        if model.cache_extra_dim:
            name += '.2 (DSA: the indexer\'s keys in the cache rows)'
        return (f'{name} geometry, {model.num_layers} layers, MLA (one latent kv head of '
                f'{model.cache_head_dim}), blocked-fp8 e4m3 128x128 routed experts + '
                f'{KV_LABELS[policy]}, random seeded weights')
    if model.model_type == 'mixtral':
        return (f'mixtral-8x7b geometry, {model.num_layers} layers, AWQ-form W4A16 gs128 '
                f'(attention and experts) + {KV_LABELS[policy]}, random seeded weights')
    if model.model_type == 'gpt_oss':
        return (f'gpt-oss-20b geometry, {model.num_layers} layers, MXFP4 experts + bf16 '
                f'KV, random seeded weights')
    dense = {'gemma2': 'gemma-2-9b', 'glm4': 'glm-4-9b-0414',
             'starcoder2': 'starcoder2-7b'}.get(model.model_type)
    if dense:
        return (f'{dense} geometry, {model.num_layers} layers, bf16 + {KV_LABELS[policy]}, '
                f'random seeded weights')
    family = {'phimoe': 'phi-3.5-moe', 'glm4_moe': 'glm-4.5-air',
              'deepseek': 'deepseek-moe-16b'}.get(model.model_type)
    if family:
        return (f'{family} geometry, {model.num_layers} layers, bf16 experts + '
                f'{KV_LABELS[policy]}, random seeded weights')
    width = {2048: 'tinyllama-1.1b', 4096: 'llama2-7b'}.get(model.hidden_size, 'llama')
    if model.vocab_size == LLAMA31_8B['vocab_size']:
        width = 'llama-3.1-8b'
    if model.vocab_size == QWEN3_8B_FP8['vocab_size']:
        width = 'qwen3-8b'
    method = (model.quantization_config or {}).get('quant_method')
    weights = {None: 'bf16', 'smooth_quant': 'W8A8 (SmoothQuant form)',
               'fbgemm_fp8': 'fp8-e4m3 weight-only, per-channel scales',
               'fp8': 'blocked fp8-e4m3 128x128'}.get(method, 'W4A16 gs128')
    return (f'{width} geometry, {model.num_layers} layers, {weights} + {KV_LABELS[policy]}, '
            f'random seeded weights')


HOST_WAITS = ('cudaStreamSynchronize', 'cudaEventSynchronize', 'cudaDeviceSynchronize',
              'cudaMemcpy')


def profile_phase(name, engine, prompts, new_tokens):
    """A traced run of the same requests: the device's busy share of the wall time,
    the kernels that take the most device time, every decode kernel's and split
    combine's device time, the CUDA runtime calls that take the most host time, the
    graph launches and the host's waits for the card, and whether the trace names the
    decode kernels that ran inside graphs.  Returns the row."""
    from torch.profiler import ProfilerActivity, profile
    graphs = engine.model_agent.graphs
    graphs.reset_counts()
    # the card's kernels and the CUDA runtime calls (no host op events: an eager run's
    # millions of them cost minutes to process)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t0, t1 = run_requests(engine, prompts, new_tokens)
    replays = graphs.stats()['replays']
    # the raw events, summed by name here: the profiler's own tables take minutes to
    # build over a traced run's ~10^5-10^6 events
    from torch.autograd import DeviceType
    dev_ns, dev_n, host_ns, calls = (collections.Counter() for _ in range(4))
    for e in prof.profiler.kineto_results.events():
        key = e.name()[:110]
        if e.device_type() == DeviceType.CUDA:
            dev_ns[key] += e.duration_ns()
            dev_n[key] += 1
        else:
            host_ns[key] += e.duration_ns()
            calls[key] += 1
    busy_us = sum(dev_ns.values()) / 1e3

    def top(ns, n):
        """The 8 largest (ms, calls) by name cut to 110 characters, summed over the
        kernels whose names share that start (template instances of one kernel)."""
        best = ns.most_common(8)
        return {k: v / 1e6 for k, v in best}, {k: n[k] for k, _ in best}
    device_ms, device_calls = top(dev_ns, dev_n)
    host_ms, host_calls = top(host_ns, calls)
    # every decode kernel and split combine, whether or not among the 8 largest
    decoding = [k for k in dev_ns if 'paged_decode' in k or 'decode_split_combine' in k]
    decode_ms = {k: dev_ns[k] / 1e6 for k in decoding}
    decode_calls = {k: dev_n[k] for k in decoding}
    row = {'phase': 'profile', 'of': name, 'wall_ms': (t1 - t0) * 1e3,
           'device_busy_ms': busy_us / 1e3,
           'device_busy_share': busy_us / 1e3 / ((t1 - t0) * 1e3) if busy_us else None,
           'graph_replays': replays, 'graph_launch_calls': calls.get('cudaGraphLaunch', 0),
           'host_wait_calls': {k: calls[k] for k in HOST_WAITS if k in calls},
           # with every decode run replayed, the decode kernels in the trace ran in graphs
           'graph_kernels_named': bool(decode_calls) if replays else None,
           'top_device_ms': device_ms, 'top_calls': device_calls,
           'decode_device_ms': decode_ms, 'decode_calls': decode_calls,
           'top_host_self_ms': host_ms, 'top_host_calls': host_calls}
    emit(row)
    return row


# -- phase 4 -------------------------------------------------------------------------
@contextlib.contextmanager
def _swapped(*swaps):
    """Set ``module.attr = fn`` for each (module, attr, fn) inside the block."""
    old = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    for m, a, fn in swaps:
        setattr(m, a, fn)
    try:
        yield
    finally:
        for m, a, fn in old:
            setattr(m, a, fn)


def _plain_kernels():
    """Inside the block the model's kernel wrappers run their plain versions on the
    card's tensors: bf16 activations with no hand-written kernel."""
    from lmdeploy_tpu_torch.nn import linear
    from lmdeploy_tpu_torch.ops import attention, moe, paged_decode
    from lmdeploy_tpu_torch.ops.flash_prefill import flash_prefill_attention_plain
    from lmdeploy_tpu_torch.ops.kv_quant import QuantKV, QuantKV4, QuantKVTurbo
    from lmdeploy_tpu_torch.ops.quant_bmm import mxfp4_bmm_plain
    from lmdeploy_tpu_torch.ops.quant_matmul import (w4a16_matmul_gd_plain,
                                                     w4a16_matmul_plain,
                                                     w4a16_matmul_szc_plain)
    quantized = {QuantKV: paged_decode.paged_decode_attention_int8_plain,
                 QuantKV4: paged_decode.paged_decode_attention_int4_plain,
                 QuantKVTurbo: paged_decode.paged_decode_attention_turbo_plain}

    def decode_plain(q, kv, tables, lens, layer, scale, hkv, logit_softcap=None,
                     window=None, sinks=None):
        if type(kv) in quantized:
            return quantized[type(kv)](q, kv, tables, lens, layer, scale, hkv, logit_softcap)
        return paged_decode.paged_decode_attention_plain(
            q, kv, tables, lens, layer, scale, hkv, logit_softcap, window, sinks)
    return _swapped((attention, 'flash_prefill_attention', flash_prefill_attention_plain),
                    (attention, 'paged_decode_attention', decode_plain),
                    (attention, 'paged_decode_attention_cp', _cp_plain()),
                    (linear, 'w4a16_matmul_gd', w4a16_matmul_gd_plain),
                    (linear, 'w4a16_matmul_szc', w4a16_matmul_szc_plain),
                    (linear, 'w4a16_matmul', w4a16_matmul_plain),
                    (moe, 'mxfp4_bmm', mxfp4_bmm_plain),
                    (moe, 'fp8_bmm', _fp8_plain_chunked))


# DeepSeek's parity traps whose logit error is reported, not held: an unrounded x
# before fp8_bmm is a no-op on the card (its x is bf16 by type), so it is planted on the
# CPU, where rounding or not moves the f32 logits by about the bf16 floor itself (the
# kernel phase holds the trap, on an f32 x); a V plane that is not zero-padded moves
# only the attention output's discarded rope columns, so it is held on those columns
# (``attn_tail_abs_max``: exactly 0 on the card's run, above 0 under the trap)
DS_REPORTED = ('x_unrounded', 'v_plane_not_zero_padded')
# over the int4 cache the decode steps' floor is the int4 error itself (0.378 on an H100
# 80GB HBM3 at 700 W), and the next group's scale row reads 0.422, too close to it to
# hold; that trap stays held by parity_deepseek_v2_lite and the fp8_bmm kernel rows
DS_KV4_REPORTED = ('next_group_scale',)


def _fp8_cpu_cached():
    """``moe.fp8_bmm`` for the parity phases: the kernel on a CUDA tensor; on the CPU
    ``fp8_bmm_plain``'s function with each stack widened once, on the card (the plain
    version re-widens a 185 M-weight stack per call, seconds on the host), and the
    'x_unrounded' trap as a variant."""
    from lmdeploy_tpu_torch.ops import quant_bmm
    from lmdeploy_tpu_torch.ops.quant_bmm import decode_fp8_e4m3
    cache = {}

    def widened(w8, gscale):
        key = (w8.data_ptr(), tuple(w8.shape))
        if key not in cache:
            K = w8.shape[-2]
            g = gscale.cuda().float().repeat_interleave(K // gscale.shape[-2], dim=-2)
            cache[key] = (decode_fp8_e4m3(w8.cuda()) * g).to(torch.bfloat16).float().cpu()
        return cache[key]

    def make(round_x):
        def bmm(x, w8, gscale):
            if x.is_cuda:
                return quant_bmm.fp8_bmm(x, w8, gscale)
            xr = x.to(torch.bfloat16).float() if round_x else x.float()
            return torch.matmul(xr, widened(w8, gscale))
        return bmm
    return make(True), make(False)


def _parity_traps(cfg16, policy: int, schedule: str = 'gd', cp: int = 1):
    """[(trap, swap, side)] ('card', 'card_run', 'cpu' or 'card_params'): the numerical
    traps of the config's quantized kernel, each planted in the plain version (W4_TRAPS
    in the decode steps' group-dot, on the CPU for 'xg_unrounded', the only side with an x
    wider than bf16; the fast / precise and unprepared products' traps of a W4A16
    ``schedule`` likewise on the card, and for 'corr_unrounded_scales' in the card's
    prepared leaves (side 'card_params': ``swap`` is then the raw-tree transform);
    MX_TRAPS in every MXFP4 product of the card's run; KV_TRAPS in the decode steps'
    attention over the cache of ``policy``; with ``cp`` > 1 the context-parallel
    decode's CP_TRAPS (those a model without sinks can show) in the decode steps; an
    8-bit format's wrong scale mapping in its product, and W8A8's per-tensor activation
    scale in the whole card run, prefill included (side 'card_run'))."""
    from lmdeploy_tpu_torch.nn import linear
    from lmdeploy_tpu_torch.ops import attention, moe
    if cp > 1:
        return [(t, (attention, 'paged_decode_attention_cp', _cp_plain(t)), 'card')
                for t in CP_TRAPS if t != 'sinks_on_each_rank']
    kv_traps = []
    if policy in KV_POLICIES:
        kernel = KV_POLICIES[policy]
        _, plain = _kv_decode_fns(kernel)

        def trapped(trap):
            def decode(q, kv, tables, lens, layer, scale, hkv, logit_softcap=None,
                       window=None, sinks=None):
                extra = {'window': window, 'sinks': sinks} if kernel == 'paged_decode_fp8' else {}
                return plain(q, _kv_trapped(trap, kv), tables, lens, layer, scale, hkv,
                             logit_softcap=logit_softcap, **extra)
            return decode
        kv_traps = [(t, (attention, 'paged_decode_attention', trapped(t)), 'card')
                    for t in KV_TRAPS[kernel]]
    if cfg16.is_mla:
        from lmdeploy_tpu_torch.models import deepseek
        orig = deepseek.DeepseekV2Model._mla_qkv

        def v_not_padded(self, w, x, cos, sin):
            q, k, _, qr = orig(self, w, x, cos, sin)
            return q, k, k, qr

        def next_group(x, w8, gscale):
            return _fp8_trapped('next_group_scale')(x, w8, gscale) if x.is_cuda \
                else _fp8_cpu_cached()[0](x, w8, gscale)
        return [('rope_not_deinterleaved', (deepseek, '_deinterleave', lambda x: x), 'card'),
                ('v_plane_not_zero_padded',
                 (deepseek.DeepseekV2Model, '_mla_qkv', v_not_padded), 'card'),
                ('next_group_scale', (moe, 'fp8_bmm', next_group), 'card'),
                ('x_unrounded', (moe, 'fp8_bmm', _fp8_cpu_cached()[1]), 'cpu')] + kv_traps
    if kv_traps:
        return kv_traps
    fmt = w8_format(cfg16)
    if fmt:
        trap = 'scale_from_next_' + ('block_row' if fmt == 'fp8_blocked' else 'column')
        return [(trap, (linear, W8_PRODUCT[fmt], _w8_trapped(fmt)), 'card')] + [
            (t, (linear, 'quantize_rows_int8', _int8_quant_trapped(t)), 'card_run')
            for t in (W8A8_LEAF_TRAPS[:1] if fmt == 'w8a8' else ())]
    if cfg16.model_type in MOE_FAMILY:
        return _moe_traps(MOE_FAMILY[cfg16.model_type])
    if cfg16.model_type in DENSE_FAMILY:
        return _dense_traps(DENSE_FAMILY[cfg16.model_type])
    method = (cfg16.quantization_config or {}).get('quant_method')
    if method == 'mxfp4':
        return [(t, (moe, 'mxfp4_bmm', _mx_trapped(t)), 'card') for t in MX_TRAPS]
    if method and schedule in ('fast', 'precise'):
        traps = [(t, (linear, 'w4a16_matmul_szc', _szc_trapped(t)), 'card')
                 for t in SZC_TRAPS[schedule]
                 if t not in ('corr_unrounded_scales', 'xg_unrounded')]
        if schedule == 'fast':
            traps.append(('corr_unrounded_scales', _corr_unrounded, 'card_params'))
        return traps
    if method and schedule == 'unprepared':
        return [(t, (linear, 'w4a16_matmul', _unprep_trapped(t)), 'card')
                for t in UNPREP_TRAPS]
    if method:
        return [(t, (linear, 'w4a16_matmul_gd', _gd_trapped(t)),
                 'cpu' if t == 'xg_unrounded' else 'card') for t in W4_TRAPS]
    return []


def _corr_unrounded(raw: dict) -> dict:
    """The fast schedule's prepared tree with every corr built from the unrounded f32
    scales (ROADMAP section 3, trap 2), from the raw tree ``raw``."""
    layers = dict(raw['layers'])
    for name, leaf in layers.items():
        if isinstance(leaf, dict) and 'scales' in leaf and leaf['packed'].dim() == 3:
            s = leaf['scales'].float()
            layers[name] = {'packed': leaf['packed'], 'sb': s.to(torch.bfloat16),
                            'corr': (leaf['zeros'].float() + 128.0) * s}
    return dict(raw, layers=layers)


def parity_phase(name: str, cfg16, tol: float, policy: int = 0, schedule: str = 'gd',
                 cp: int = 1):
    """2 full-width layers: the card (bf16, kernels) against the port on the CPU (f32,
    plain paths) on the same weights, prefill logits and 8 teacher-forced decode
    steps.  W4A16 leaves are the same int32 words and f32 scales on both sides; MXFP4
    experts are the same codes and scales, which the CPU side takes widened to f32
    (exactly the weights the kernel decodes; a widened stack is 1 GB a layer, and the
    CPU's plain MXFP4 product would widen it again for every call).  W8A8 leaves are
    the same int8 codes and f32 scales, and the CPU quantizes the bf16 rounding of its
    f32 activations, as the card quantizes its bf16 ones: codes near a rounding boundary
    would otherwise flip on every bf16 error and set the floor.

    A MoE model's card runs take the CPU run's expert choices (the card's own router
    logits weight them), so a near-tie that bf16 breaks the other way cannot move the
    held logits: the comparison isolates the numerics.  The card's own choices are
    recorded all the same: a routing flip is a token whose chosen experts differ
    from the CPU's, and a flip is a fault unless the CPU's f32 margin between the
    k-th and (k+1)-th router logits lies within twice the largest router-logit
    difference of that layer and step (the bf16 error).  What free routing reads is
    reported beside it (``free_routing_max_abs_logit_err``), not held.

    Beside it, what the same comparison reads (max |logit error|): ``floor`` -- the
    card with every kernel swapped for its plain version (bf16 activations alone);
    and each trap of ``_parity_traps``.  The allowance must lie above ``floor`` and
    below every trap.  ``policy`` is the KV cache's quant_policy on both sides.  With
    one of the caches this slice adds, the card's prefill attends the chunk's exact K/V
    (flash_prefill) while the CPU's attends the quantized cache, as in the reference:
    the prefill logits then differ by the quantization error itself
    (``prefill_logit_err``), so the phase holds the decode steps, where the policy's
    kernel runs, and its traps are planted.  Weights are built once for consecutive
    phases of one config.  ``schedule`` names the W4A16 schedule both sides' attention
    projections take (gd, fast, precise or unprepared), with its own kernel on the card
    and that kernel's plain version on the CPU.  ``cp`` > 1 stripes both sides' caches
    over that many ranks (the card's all on the one card, the CPU's on the CPU), so the
    decode steps take the context-parallel partials and combine.  MLA's attention output
    keeps its rope columns at exactly 0 on the card except over the int4 cache, whose
    asymmetric codes give the V plane's zero tail a rounding residue (as the
    reference's): there the V-plane trap is reported only."""
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.parallel.mesh import StripedKV, build_mesh
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    from lmdeploy_tpu_torch.ops import moe as moe_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m16 = build_model(cfg16)
    m32 = build_model(dataclasses.replace(cfg16, dtype='float32'))
    meshes = {}
    if cp > 1:
        meshes = {'cuda': build_mesh(cp=cp, devices=['cuda:0'] * cp),
                  'cpu': build_mesh(cp=cp, devices=['cpu'] * cp)}
        m16.cp_mesh, m32.cp_mesh = meshes['cuda'], meshes['cpu']
    w_cpu, w_gpu, raw_gpu = _parity_weights(cfg16, m16, m32, schedule)
    # MLA: the CPU's fp8 expert products through stacks widened once, and the card's
    # attention outputs' rope columns (the V plane's zero tail) recorded
    restore = contextlib.ExitStack()
    tail = {'max': 0.0}
    if cfg16.is_mla:
        from lmdeploy_tpu_torch.models import deepseek
        attend = deepseek.paged_attention

        def attend_rec(q, *args, **kwargs):
            out = attend(q, *args, **kwargs)
            if out.is_cuda:
                tail['max'] = max(tail['max'], out[..., cfg16.kv_lora_rank:].abs().max().item())
            return out
        restore.enter_context(_swapped((moe_ops, 'fp8_bmm', _fp8_cpu_cached()[0]),
                                       (deepseek, 'paged_attention', attend_rec)))
    w8a8 = w8_format(cfg16) == 'w8a8'
    if w8a8:
        restore.enter_context(_swapped(_int8_quant_bf16_on_cpu()))
    B, T, BS, steps = 2, 256, 128, 8
    pages = (T + steps + BS - 1) // BS
    NB = 1 + B * pages

    def new_cache(dev):
        kv = new_kv_cache(m32.config if dev == 'cpu' else cfg16, NB, BS, policy, dev)
        if cp == 1:
            return kv
        # stale pages, as a served cache's reused blocks hold them: a rank that reads its
        # slots at another rank's positions takes them in (zeroed pages would hide it)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        kv.copy_(torch.randn(kv.shape, generator=gen, device=dev).to(kv.dtype))
        return StripedKV.from_reference_layout(kv, meshes[dev].cp_devices)
    tables = (1 + torch.arange(B * pages)).reshape(B, pages).int()
    cos, sin = make_rope_table(cfg16.rope_dim, 1024, cfg16.rope_theta, cfg16.rope_scaling)
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(3, 32000, size=(B, T))).int()
    # the two sides: the CPU reference and the card
    side = {'cpu': (m32, w_cpu, 'cpu'), 'card': (m16, w_gpu, 'cuda')}
    # (the scores the choice ranks, choices, weights) per routed layer and step
    routes = {'cpu': [], 'card': []}
    route = {'record': True, 'force': False, 'j': 0, 'weight_jumps': 0}
    moe = hasattr(m16, 'route')
    take_weights = cfg16.model_type in FORCED_WEIGHTS
    for name_, (model, _, _) in side.items():
        if moe:
            def rec(w_, xf, _route=model.route, _log=routes[name_], _card=name_ == 'card',
                    _model=model):
                logits, idx, wts = _route(w_, xf)
                ranked = (_model.choice_scores(w_, logits)
                          if hasattr(_model, 'choice_scores') else logits)
                if route['record']:
                    _log.append((ranked.float().cpu(), idx.cpu(), wts.float().cpu()))
                if _card and route['force']:
                    _, cpu_idx, cpu_wts = routes['cpu'][route['j']]
                    idx = cpu_idx.to(idx.device)
                    route['j'] += 1
                    wts = (_model.route_weights(w_, logits, idx)
                           if hasattr(_model, 'route_weights')
                           else torch.softmax(logits.gather(-1, idx), dim=-1))
                    if take_weights:
                        if route['record']:
                            route['weight_jumps'] += int(
                                ((wts.float().cpu() - cpu_wts).abs() > 1e-2).sum())
                        wts = cpu_wts.to(wts.device, wts.dtype)
                return logits, idx, wts
            model.route = rec

    def step(which, kv, tok, hist, q_len, fresh):
        model, params, dev = side[which]
        meta = AttnMeta(tables.to(dev), torch.full((B,), hist, dtype=torch.int32).to(dev),
                        torch.full((B,), q_len, dtype=torch.int32).to(dev))
        pos = (hist + torch.arange(tok.shape[1]))[None].expand(B, -1).int()
        # the CPU's dense expert stacks take the grouped GEMM at every row count: the
        # dense combine's f32 products, summed in another order, without reading every
        # expert of a layer from host memory for a decode step's 2 rows
        with (_swapped((moe_ops, 'RAGGED_MIN_TOKENS', 1)) if dev == 'cpu'
              else contextlib.nullcontext()):
            return model.forward(params, tok.to(dev), pos.to(dev), kv, meta,
                                 cos.to(dev), sin.to(dev), fresh_prefill=fresh).float().cpu()

    def prefill(which):
        route['j'] = 0
        kv = new_cache(side[which][2])
        return step(which, kv, ids, 0, T, True), kv

    def decode(which, kv, toks):
        return [step(which, kv, tok, T + i, 1, False) for i, tok in enumerate(toks)]

    # the f32 CPU run teacher-forces its own argmax tokens; every other run takes them
    lc0, kv_cpu = prefill('cpu')
    kv_cpu0, cpu, toks = kv_cpu.clone(), [lc0], []
    for i in range(steps):
        toks.append(cpu[-1].argmax(-1, keepdim=True).int())
        cpu.append(step('cpu', kv_cpu, toks[-1], T + i, 1, False))
    route['force'] = moe
    tail['max'] = 0.0
    # a softcapped model's raw scores on the card, each layer's (std, max |s|)
    spread = []
    softcapped = getattr(m16, 'attn_logit_softcap', None)
    with _swapped(_recording_scores(spread)) if softcapped else contextlib.nullcontext():
        lg0, kv_gpu = prefill('card')
    kv_gpu0 = kv_gpu.clone()
    card = [lg0] + decode('card', kv_gpu, toks)
    card_tail = tail['max']
    route['record'] = False

    # routing flips: the card's own choices against the CPU's, per routed layer and step
    n_routed = len(routes['cpu']) // (steps + 1)
    flips, flips_ok, worst, router_err = [0] * n_routed, True, 0.0, 0.0
    for j, ((lc, ic, _), (lg, ig, _)) in enumerate(zip(routes['cpu'], routes['card'])):
        err_j = (lg - lc).abs().max().item()
        router_err = max(router_err, err_j)
        diff = (ic.sort(-1).values != ig.sort(-1).values).any(-1)
        k = cfg16.num_experts_per_tok
        top = lc.sort(-1, descending=True).values
        margins = (top[:, k - 1] - top[:, k])[diff]
        flips[j % n_routed] += int(diff.sum())
        if diff.any():
            worst = max(worst, margins.max().item() / err_j)
            flips_ok &= bool((margins <= 2 * err_j).all())

    held = 1 if policy in KV_POLICIES else 0     # the first step held

    def max_err(a, b):
        return max((x - y).abs().max().item() for x, y in list(zip(a, b))[held:])
    errs, agree, decided, argmax_fault = [], 0, 0, None
    for i, (lc, lg) in enumerate(zip(cpu, card)):
        errs.append((lg - lc).abs().max().item())
        top2 = lc.topk(2, dim=-1).values
        margin_ok = (top2[:, 0] - top2[:, 1]) > 2 * tol
        same = lc.argmax(-1) == lg.argmax(-1)
        if i < held:
            continue
        agree += int(same.sum())
        decided += int(margin_ok.sum())
        if not bool(same[margin_ok].all()) and argmax_fault is None:
            argmax_fault = f'argmax differs where the f32 margin exceeds 2 x {tol} at step {i}'
    free = None
    if moe:
        route['force'] = False
        lr0, kv_r = prefill('card')
        free = max_err([lr0] + decode('card', kv_r, toks), cpu)
        route['force'] = True
        del kv_r
    with _plain_kernels():
        lf0, kv_f = prefill('card')
        floor = max_err([lf0] + decode('card', kv_f, toks), cpu)
    traps, trap_tails = {}, {}
    for trap, swap, which in _parity_traps(cfg16, policy, schedule, cp):
        tail['max'] = 0.0
        if which == 'card_params':
            side['card'] = (m16, swap(raw_gpu), 'cuda')
            lt0, kv_t = prefill('card')
            traps[trap] = max_err([lt0] + decode('card', kv_t, toks), cpu)
            side['card'] = (m16, w_gpu, 'cuda')
            del kv_t
            continue
        with _swapped(swap):
            if which == 'cpu':
                traps[trap] = max_err([lc0] + decode('cpu', kv_cpu0.clone(), toks), card)
            elif moe or which == 'card_run':      # the whole card run is planted
                lt0, kv_t = prefill('card')
                traps[trap] = max_err([lt0] + decode('card', kv_t, toks), cpu)
            else:
                traps[trap] = max_err([lg0] + decode('card', kv_gpu0.clone(), toks), cpu)
        if cfg16.is_mla and which == 'card':
            trap_tails[trap] = tail['max']
    restore.close()
    reported = (SZC_PARITY_REPORTED.get(schedule, ()) + (DS_REPORTED if cfg16.is_mla else ())
                + (DS_KV4_REPORTED if cfg16.is_mla and policy == 8 else ()))
    ok = (max(errs[held:]) <= tol and flips_ok and argmax_fault is None
          and all(v > tol for t, v in traps.items() if t not in reported))
    tail_held = cfg16.is_mla and policy != 8
    if tail_held:
        ok = ok and card_tail == 0.0 and trap_tails['v_plane_not_zero_padded'] > 0.0
    row = {'phase': name, 'layers': 2, 'model': model_label(cfg16, policy), 'batch': B,
           'cp': cp,
           'w4a16_schedule': schedule if (cfg16.quantization_config or {}).get(
               'quant_method') in ('awq', 'gptq') else None,
           'prompt': T, 'decode_steps': steps, 'vocab': cfg16.vocab_size,
           'held_steps': 'decode' if held else 'prefill and decode',
           'max_abs_logit_err': max(errs[held:]), 'prefill_logit_err': errs[0],
           'per_step_err': errs, 'tol': tol,
           'floor_bf16_plain': floor, 'trap_max_abs_logit_err': traps,
           'logit_abs_max': cpu[-1].abs().max().item(),
           'argmax_agree': agree, 'positions': B * (steps + 1 - held),
           'positions_with_margin': decided, 'argmax_fault': argmax_fault, 'ok': ok}
    if w8a8:
        row.update(cpu_int8_input='the bf16 rounding of its f32 activations')
    if spread:
        row.update(attn_score_std=[a for a, _ in spread],
                   attn_score_abs_max=[b for _, b in spread])
    if cfg16.is_mla:
        row.update(traps_reported=[t for t in reported if t in traps],
                   attn_tail_abs_max=card_tail,
                   trap_attn_tail_abs_max=trap_tails, attn_tail_held=tail_held)
    if take_weights:
        row.update(weights='card runs take the CPU run\'s routing weights too',
                   routing_weight_jumps=route['weight_jumps'])
    if moe:
        row.update(routing='card runs take the CPU run\'s expert choices',
                   routing_decisions=sum(int(ic.shape[0]) for _, ic, _ in routes['cpu']),
                   routing_flips_by_layer=flips, router_logit_err_max=router_err,
                   worst_flip_margin_over_layer_err=worst,
                   flips_within_bf16_error=flips_ok, free_routing_max_abs_logit_err=free)
    emit(row)
    del kv_gpu, kv_gpu0, kv_f, w_gpu, raw_gpu, side
    gc.collect()
    torch.cuda.empty_cache()
    if not row['ok']:
        raise SystemExit(f'{name} failed (over its allowance, a trap reads within it, a '
                         f'routing flip beyond the bf16 error, or an argmax that differs '
                         f'beyond twice the allowance): {row}')


def _recording_scores(spread: list):
    """A swap of the gathered prefill attention that appends, for each call on the
    card, the (std, max |s|) of its raw scores q.k * scale (before any softcap) over
    the causal entries: the spread a softcapped decode case's q is scaled to."""
    from lmdeploy_tpu_torch.ops import attention as att
    gathered = att.attention_dense_gathered

    def recorded(q, k, v, history_lens, scale, *args, **kwargs):
        if q.is_cuda:
            B, T, Hq, D = q.shape
            Hkv, _, S, _ = k.shape
            s = torch.einsum('bthgd,hbsd->bhgts', q.reshape(B, T, Hkv, Hq // Hkv, D).float(),
                             k.float()) * scale
            pos_q = history_lens.long()[:, None] + torch.arange(T, device=q.device)
            causal = torch.arange(S, device=q.device)[None, None, :] <= pos_q[:, :, None]
            s = s[causal[:, None, None].expand_as(s)]
            spread.append((s.std().item(), s.abs().max().item()))
        return gathered(q, k, v, history_lens, scale, *args, **kwargs)
    return att, 'attention_dense_gathered', recorded


_PARITY_WEIGHTS = {}


def _parity_weights(cfg16, m16, m32, schedule: str = 'gd'):
    """(CPU f32, card bf16, card raw) parameter trees with identical values:
    bf16-representable dense weights, the same quantized words, codes and f32 scales,
    the W4A16 linears prepared for ``schedule`` on both sides (the raw card tree
    unprepared).  Expert stacks (MXFP4, W4A16) go to the CPU widened to f32 on the card:
    exactly the weights the card's products decode, and the CPU's plain products would
    widen a 1-3.8 GB stack for every call.  The raw trees are kept for the next parity
    phase of the same config (the three KV policies and the four W4A16 schedules each
    share one)."""
    from lmdeploy_tpu_torch.ops.quant_bmm import widen_mxfp4
    from lmdeploy_tpu_torch.ops.quant_matmul import dequant_w4
    key = json.dumps(dataclasses.asdict(cfg16), sort_keys=True, default=str)
    if key not in _PARITY_WEIGHTS:
        _PARITY_WEIGHTS.clear()
        w = m32.init_params(SEED, device='cpu', dtype=torch.float32)
        if cfg16.model_type in DENSE_FAMILY:
            w = _dense_parity_tree(w, DENSE_FAMILY[cfg16.model_type])
        raw_cpu = m32.fuse_projections(_bf16_tree(w, 'cpu', torch.float32))
        for key_, leaf in list(raw_cpu['layers'].items()):
            if isinstance(leaf, dict) and 'nib' in leaf:
                raw_cpu['layers'][key_] = torch.stack([
                    widen_mxfp4(n.cuda(), s.cuda(), torch.float32).cpu()
                    for n, s in zip(leaf['nib'], leaf['scale'])])
            elif isinstance(leaf, dict) and 'packed' in leaf and leaf['packed'].dim() == 4:
                gs = leaf['packed'].shape[-2] * 8 // leaf['scales'].shape[-2]
                raw_cpu['layers'][key_] = torch.stack([
                    dequant_w4(p.cuda(), s.cuda(), z.cuda(), gs, torch.float32).cpu()
                    for p, s, z in zip(leaf['packed'], leaf['scales'], leaf['zeros'])])
        raw_gpu = m16.fuse_projections(_bf16_tree(w, 'cuda', torch.bfloat16))
        _PARITY_WEIGHTS[key] = (raw_cpu, raw_gpu)
    raw_cpu, raw_gpu = _PARITY_WEIGHTS[key]
    if schedule == 'unprepared':
        return raw_cpu, raw_gpu, raw_gpu
    return (m32.prep_quant_leaves(raw_cpu, mode=schedule),
            m16.layout_quant_leaves(m16.prep_quant_leaves(raw_gpu, mode=schedule)), raw_gpu)


def _bf16_tree(params, device, dtype):
    """Dense float leaves rounded to bf16, then in ``dtype`` on ``device``; quantized
    dict leaves (W4A16 words, scales and zeros; MXFP4 codes and scales) and integer
    leaves move unchanged."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict) and ('packed' in v or 'nib' in v or 'w8' in v):
            out[k] = {k2: v2.to(device) for k2, v2 in v.items()}
        elif isinstance(v, dict):
            out[k] = _bf16_tree(v, device, dtype)
        elif not v.is_floating_point():
            out[k] = v.to(device)
        else:
            out[k] = v.bfloat16().to(device, dtype)
    return out


def _layer_lead(rows, names, m):
    """Times and bounds summed over one layer's projections ``names`` at M = ``m``."""
    layer = [r for r in rows if r['shape'][0] == m and r['case'].rsplit('_m', 1)[0] in names]
    lead = {k: sum(r[k] for r in layer) for k in ('kernel_ms', 'plain_ms', 'bound_ms')}
    lead['bound_by'] = 'bytes' if all(r['bound_by'] == 'bytes' for r in layer) \
        else 'operations'
    lib = [r['library_ms'] for r in layer]
    lead['library_ms'] = sum(lib) if None not in lib else None
    lead['dense_bf16_ms'] = sum(r['dense_bf16_ms'] for r in layer)
    return lead


def deepseek_e2e_phase(card: str) -> dict:
    """e2e_deepseek_v2_lite_fp8: DeepSeek-V2-Lite at full width and LDS of its 27 layers
    (1 dense, the rest MoE) with seeded blocked-fp8 routed experts and a bf16 MLA cache, 63
    concurrent 1024-token prompts and one of 4096, 64 greedy tokens each, run twice, then
    traced.  Each decode step (64 rows) launches fp8_bmm three times a MoE layer (the
    dense combine's gate, up and down) and paged_decode once a layer; each prefill step
    whose chunks all start their prompts launches flash_prefill once a layer, exactly;
    every prefill step has >= 768 rows, so its experts are widened for the grouped GEMM
    and fp8_bmm does not launch there."""
    cfg = deepseek_config(LDS)
    L, moe_layers = cfg.num_layers, cfg.num_layers - cfg.first_k_dense_replace
    return e2e_phase('e2e_deepseek_v2_lite_fp8', cfg, 64, 0, 63,
                     {'flash_prefill': (L, 0), 'paged_decode': (0, L),
                      'fp8_bmm': (0, 3 * moe_layers)},
                     card, short_len=1024, long_len=4096, exact=True)


# -- the 8-bit linear leaves and the MoE families -------------------------------------
# the dense llama family's 8-bit checkpoint formats, the public config each is served
# at, the nn/linear.py product each takes, and its phases' name
W8_CONFIGS = {'w8a8': LLAMA31_8B_W8A8, 'fp8': LLAMA31_8B_FP8, 'fp8_blocked': QWEN3_8B_FP8}
W8_PRODUCT = {'w8a8': '_w8a8', 'fp8': '_w_fp8', 'fp8_blocked': '_w_fp8_blocked'}
W8_PHASE = {'w8a8': 'llama31_8b_w8a8', 'fp8': 'llama31_8b_fp8', 'fp8_blocked': 'qwen3_8b_fp8'}
MOE_CONFIGS = {'phimoe': PHI35_MOE, 'glm45_air': GLM45_AIR,
               'deepseek_moe_16b': DEEPSEEK_MOE_16B}
MOE_FAMILY = {'phimoe': 'phimoe', 'glm4_moe': 'glm45_air', 'deepseek': 'deepseek_moe_16b'}
# the e2e phases' depth, cut from the configs' 32 / 32 / 36 (8-bit formats) and 32 / 46 /
# 28 layers (MoE families) so that the script stays inside its time limit beside the
# earlier phases (to 2 when the MTP / DSA cells joined: the MoE families keep a dense
# and a MoE layer, PhiMoE two MoE layers); width, experts, vocab and traffic stay as
# published
L8 = 2
LMOE = 2
# the _int_mm route's check: Llama-3.1-8B's fused wqkv (K 4096, N 6144), decode rows
# on both sides of cuBLASLt's 17-row minimum and a prefill chunk's
INT_MM_SHAPE = (4096, 6144)
INT_MM_ROWS = (1, 16, 17, 64, 2048)
# the new parity phases, 2 full-width layers, card bf16 against CPU f32.  A first card
# run read (H100 80GB HBM3, 700 W), floor (plain versions on the card) / kernels / held
# traps: W8A8 0.528 / 0.491 / 8.40 (each column with the next column's scale) and 1.116
# (one activation scale for the whole tensor), with the CPU quantizing the bf16
# rounding of its activations (0.630 / 0.605 when it quantized the f32 ones): codes
# that lie within a bf16 error of a rounding boundary still flip on the errors of the
# layers before, so its floor is ~5x the other formats' and its allowance 1.5x its
# floor, below the per-tensor trap (the int_mm phase holds that trap and rounding half
# up exactly on the product); fp8 0.098 / 0.102 / 7.69; Qwen3-8B blocked fp8 0.085 /
# 0.079 / 6.78 (each block row of K with the next one's scales); Phi-3.5-MoE 0.119 /
# 0.113 / 6.50 (every expert's gate and up stacks swapped; on the CPU run's routing
# weights, below); GLM-4.5-Air 0.094 / 0.096 / 3.84 (norm_topk_prob read the other
# way); DeepSeek-MoE 16B 0.047 / 0.045 / 0.474 (the same).  Each other allowance is
# about twice its floor
LOGIT_TOL_W8 = {'w8a8': 0.8, 'fp8': 0.2, 'fp8_blocked': 0.2}
LOGIT_TOL_MOE = {'phimoe': 0.2, 'glm45_air': 0.2, 'deepseek_moe_16b': 0.1}
# families whose card runs take the CPU run's routing weights as well as its choices:
# sparsemixer keeps the experts within 2 x jitter (relative) of the best, a threshold
# the bf16 router logits cross where the f32 ones do not, and each crossing moves a
# weight by up to a half
FORCED_WEIGHTS = ('phimoe',)


def w8_config(fmt: str, num_layers: int = None):
    """The public config of the 8-bit format ``fmt``, depth cut to ``num_layers``."""
    from lmdeploy_tpu_torch.config import ModelConfig
    cfg = W8_CONFIGS[fmt]
    return ModelConfig.from_hf_config(
        dict(cfg, num_hidden_layers=num_layers or cfg['num_hidden_layers']))


def moe_config(family: str, num_layers: int = None):
    """The public config of the MoE ``family``, depth cut to ``num_layers``.  PhiMoE's
    longrope factor lists are seeded (64 each: short ones near 1, long ones rising to
    ~40, as the published lists do) and its original_max_position_embeddings (4096) put
    in rope_scaling, where the reference reads it, so that a session above 4096 tokens
    takes the long factors and the attention factor."""
    from lmdeploy_tpu_torch.config import ModelConfig
    cfg = dict(MOE_CONFIGS[family])
    cfg['num_hidden_layers'] = num_layers or cfg['num_hidden_layers']
    if family == 'phimoe':
        rng = np.random.RandomState(SEED)
        half = cfg['hidden_size'] // cfg['num_attention_heads'] // 2
        cfg['rope_scaling'] = {
            'type': 'longrope', 'original_max_position_embeddings':
                cfg['original_max_position_embeddings'],
            'short_factor': (1.0 + 0.2 * rng.rand(half)).tolist(),
            'long_factor': np.sort(1.0 + 40.0 * rng.rand(half)).tolist()}
    return ModelConfig.from_hf_config(cfg)


def w8_format(cfg):
    """'w8a8', 'fp8' or 'fp8_blocked' for a dense llama-family 8-bit config, else None."""
    qcfg = cfg.quantization_config or {}
    method = qcfg.get('quant_method')
    if cfg.is_mla or method not in ('smooth_quant', 'w8a8', 'fp8', 'fbgemm_fp8'):
        return None
    if method in ('smooth_quant', 'w8a8'):
        return 'w8a8'
    return 'fp8_blocked' if qcfg.get('weight_block_size') else 'fp8'


def int_mm_phase(card: str) -> dict:
    """The W8A8 product's int8 route on the card: ``nn.linear.int8_matmul``
    (``torch._int_mm``, rows padded up to cuBLASLt's 17) on K-major codes (the layout
    ``LlamaModel.layout_quant_leaves`` gives them) against an f64 product of the same
    int8 codes (exact: every sum is an integer below 2^53), bit for bit, at M = 1, 16,
    17, 64 and 2048, called eagerly and replayed from a captured CUDA graph; its time
    beside the same product on row-major codes and the bf16 GEMM of the same shape.
    Then ``w8a8_leaf_check``, the whole W8A8 product, bit for bit.  Then the fp8
    weight-only product's f32-output GEMM (``f32_out_mm`` on bf16 operands) against the
    exact f32 products (TF32 off; only the order of the f32 sums may differ), and the
    device times of the three 8-bit products of one projection at M = 64 (the e2e
    decode bucket), each with the dense bf16 GEMM beside it: the fp8 products widen
    their weights at every call."""
    from lmdeploy_tpu_torch.nn import linear as lin
    torch.backends.cuda.matmul.allow_tf32 = False
    K, N = INT_MM_SHAPE
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    w8_rows = torch.randint(-127, 128, (K, N), generator=gen, device='cuda', dtype=torch.int8)
    w8 = w8_rows.t().contiguous().t()                  # K-major, as the main path's
    wd = w8.double()
    wb = (torch.randn(K, N, generator=gen, device='cuda') * 0.02).bfloat16()
    rows = []
    for M in INT_MM_ROWS:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device='cuda', dtype=torch.int8)
        exact = xq.double() @ wd
        eager = lin.int8_matmul(xq, w8)
        static = xq.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = lin.int8_matmul(static, w8)
        graph.replay()
        torch.cuda.synchronize()
        xb = torch.randn(M, K, generator=gen, device='cuda').bfloat16()
        rows.append({'M': M, 'dtype': str(eager.dtype), 'shape': list(eager.shape),
                     'eager_exact': torch.equal(eager.double(), exact),
                     'graph_exact': torch.equal(out.double(), exact),
                     'int_mm_ms': time_ms(lambda: lin.int8_matmul(xq, w8)),
                     'row_major_codes_ms': time_ms(lambda: lin.int8_matmul(xq, w8_rows)),
                     'bf16_gemm_ms': time_ms(lambda: xb @ wb),
                     # int8 at 1,979 TOP/s, twice the bf16 rate
                     'bound_ms': bound(2 * M * K * N * 0.5, M * K + K * N + 4 * M * N)[0]})
        del graph
    leaf = w8a8_leaf_check(gen, w8, torch.rand(N, generator=gen, device='cuda') * 1e-3)
    # the fp8 weight-only product's f32 output GEMM, and the 8-bit products at M = 64
    x = torch.randn(64, K, generator=gen, device='cuda').bfloat16()
    wf8 = (torch.randn(K, N, generator=gen, device='cuda') * 112).clamp(-448, 448).to(
        torch.float8_e4m3fn)
    got = lin.f32_out_mm(x, wf8.to(torch.bfloat16))
    ref = x.float() @ wf8.float()
    f32_err = ((got - ref).abs().max() / ref.abs().max()).item()
    scale = torch.rand(N, generator=gen, device='cuda') * 1e-3
    bscale = torch.rand(K // 128, N // 128, generator=gen, device='cuda') * 1e-3
    leaves = {'w8a8': {'w8': w8, 'scale': scale}, 'fp8': {'w8': wf8, 'scale': scale},
              'fp8_blocked': {'w8': wf8, 'bscale': bscale}}
    products = {fmt: {'ms': time_ms(lambda f=fmt: lin.linear(x, leaves[f])),
                      'weight_bytes': K * N + 4 * (N if fmt != 'fp8_blocked'
                                                   else bscale.numel())}
                for fmt in leaves}
    products['widen_fp8_to_bf16_ms'] = time_ms(lambda: wf8.to(torch.bfloat16))
    products['widen_fp8_blocked_ms'] = time_ms(lambda: lin.widen_fp8_blocked(wf8, bscale))
    products['dense_bf16_ms'] = time_ms(lambda: x @ wb)
    row = {'phase': 'int_mm', 'card': card, 'shape_k_n': [K, N], 'rows': rows,
           'w8a8_leaf': leaf,
           'f32_out_mm': {'dtype': str(got.dtype), 'max_err_over_max_ref': f32_err},
           'products_m64': products}
    row['ok'] = (all(r['eager_exact'] and r['graph_exact'] and r['dtype'] == 'torch.int32'
                     for r in rows) and leaf['ok']
                 and got.dtype == torch.float32 and f32_err < 1e-5)
    emit(row)
    if not row['ok']:
        raise SystemExit(f'int_mm phase failed: {row}')
    return row


def w8a8_leaf_check(gen, w8, scale) -> dict:
    """The whole W8A8 product on the card (``nn.linear.linear`` on a ``{'w8', 'scale'}``
    leaf of K-major codes: the row quantizer, ``_int_mm`` and the f32 epilogue) against
    a reference of the same bf16 x, bit for bit: codes and row scales from the CPU's
    quantizer (``absmax * fl(1/127)``, the jitted reference's, which the CPU tests hold
    against ``jax.jit`` of ``linear``), their product in f64 on the card (exact),
    ``acc * a_scale * scale`` in
    f32 on the CPU, then bf16.  x's rows span four decades of magnitude and row 0 holds
    half-integer values under an absmax of 127 (scale 1: every code a tie).  At each M
    of INT_MM_ROWS, eager and replayed from a captured graph; at M 64 each fault of
    W8A8_LEAF_TRAPS planted on the card must change the output."""
    from lmdeploy_tpu_torch.nn import linear as lin
    K, N = w8.shape
    leaf = {'w8': w8, 'scale': scale}
    wd = w8.double()
    rows, traps = [], {}
    for M in INT_MM_ROWS:
        x = torch.randn(M, K, generator=gen, device='cuda')
        x *= torch.logspace(-2, 2, M, device='cuda')[:, None]
        x[0] = torch.randint(-127, 127, (K,), generator=gen, device='cuda') + 0.5
        x[0, 0] = 127.0
        x = x.bfloat16()
        xq, a_scale = lin.quantize_rows_int8(x.cpu())
        acc = (xq.cuda().double() @ wd).float().cpu()
        ref = (acc * a_scale * scale.cpu()[None, :]).bfloat16()
        eager = lin.linear(x, leaf)
        static = x.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = lin.linear(static, leaf)
        graph.replay()
        torch.cuda.synchronize()
        rows.append({'M': M, 'eager_exact': torch.equal(eager.cpu(), ref),
                     'graph_exact': torch.equal(out.cpu(), ref)})
        del graph
        if M != 64:
            continue
        for trap in W8A8_LEAF_TRAPS:
            if trap == 'scale_from_next_column':
                got = lin.linear(x, dict(leaf, scale=scale.roll(-1, 0)))
            else:
                with _swapped((lin, 'quantize_rows_int8', _int8_quant_trapped(trap))):
                    got = lin.linear(x, leaf)
            diff = (got.cpu().float() - ref.float()).abs()
            traps[trap] = {'changed_outputs': int((diff > 0).sum()),
                           'max_abs_diff_over_max_ref':
                               (diff.max() / ref.float().abs().max()).item()}
    ok = (all(r['eager_exact'] and r['graph_exact'] for r in rows)
          and all(t['changed_outputs'] > 0 for t in traps.values()))
    return {'rows': rows, 'traps': traps, 'ok': ok}


def routing_ties_phase(card: str) -> dict:
    """Sparsemixer on the card against the CPU (whose choices and weights the CPU tests
    hold against the JAX package) on Phi-3.5-MoE's 16 experts: random router logits
    and rows with a three-way and a two-way tie at the top, an all-equal row and
    scores at the jitter threshold.  The choices must be equal (ties to the lower
    expert index, as jnp.argmax) and the weights within 1e-6; torch.argmax's own pick
    on ties is printed beside it."""
    from lmdeploy_tpu_torch.models.phimoe import sparsemixer_route
    E = PHI35_MOE['num_local_experts']
    logits = np.random.RandomState(SEED).randn(64, E).astype(np.float32)
    logits[0, [3, 7, 11]] = 4.0
    logits[1, [2, 9]] = 3.0
    logits[1, 5] = 2.0
    logits[2] = 0.0
    logits[3] = 0.0
    logits[3, :4] = np.float32(1.0) - np.float32([0.0, 0.02, 0.019999, 0.020001])
    x = torch.from_numpy(logits)
    cpu_idx, cpu_w = sparsemixer_route(x, 0.01)
    card_idx, card_w = sparsemixer_route(x.cuda(), 0.01)
    row = {'phase': 'routing_ties', 'card': card, 'experts': E,
           'choices_equal': torch.equal(cpu_idx, card_idx.cpu()),
           'weights_max_abs_err': (cpu_w - card_w.cpu()).abs().max().item(),
           'tie_rows_choices': card_idx[:3].tolist(),
           'torch_argmax_on_card': torch.argmax(x.cuda(), dim=-1)[:3].tolist()}
    row['ok'] = (row['choices_equal'] and row['weights_max_abs_err'] <= 1e-6
                 and row['tie_rows_choices'] == [[3, 7], [2, 9], [0, 1]])
    emit(row)
    if not row['ok']:
        raise SystemExit(f'routing_ties phase failed: {row}')
    return row


# the W8A8 product's planted faults that the int_mm phase's exact check must see (the
# parity phase holds the first as well)
W8A8_LEAF_TRAPS = ('per_tensor_act_scale', 'round_half_up', 'scale_from_next_column')


def _int8_quant_trapped(trap: str):
    """``nn.linear.quantize_rows_int8`` with one fault planted: one activation scale for
    the whole tensor ('per_tensor_act_scale') or codes rounded half up
    ('round_half_up')."""
    from lmdeploy_tpu_torch.nn import linear

    def quantize(x2d):
        xf = x2d.float()
        amax = xf.abs().amax(-1, keepdim=True)
        if trap == 'per_tensor_act_scale':
            amax = amax.amax().expand_as(amax)
        a_scale = torch.clamp_min(amax * linear._INV127, 1e-8)
        q = xf / a_scale
        q = torch.floor(q + 0.5) if trap == 'round_half_up' else torch.round(q)
        return torch.clamp(q, -127, 127).to(torch.int8), a_scale
    return quantize


def _int8_quant_bf16_on_cpu():
    """``nn.linear.quantize_rows_int8`` that quantizes the bf16 rounding of a CPU
    tensor (the card's activations are bf16; its own tensors pass unchanged)."""
    from lmdeploy_tpu_torch.nn import linear
    quantize = linear.quantize_rows_int8
    return (linear, 'quantize_rows_int8',
            lambda x2d: quantize(x2d if x2d.is_cuda else x2d.bfloat16().float()))


def _w8_trapped(fmt: str):
    """The 8-bit product of ``fmt`` with each output column's scale taken from the next
    column (blocked fp8: each block row of K with the next block row's scales)."""
    from lmdeploy_tpu_torch.nn import linear
    product = getattr(linear, W8_PRODUCT[fmt])

    def trapped(x, w):
        key = 'bscale' if 'bscale' in w else 'scale'
        return product(x, dict(w, **{key: w[key].roll(-1, 0)}))
    return trapped


def _moe_traps(family: str):
    """PhiMoE: every expert's gate and up stacks swapped (w1 read as w3); GLM-4.5 and
    DeepSeek-MoE: norm_topk_prob read the other way."""
    if family == 'phimoe':
        from lmdeploy_tpu_torch.models import mixtral
        moe_ffn = mixtral.moe_ffn

        def swapped(xf, top_idx, top_w, we_gate, we_up, we_down, *args, **kwargs):
            return moe_ffn(xf, top_idx, top_w, we_up, we_gate, we_down, *args, **kwargs)
        return [('gate_up_swapped', (mixtral, 'moe_ffn', swapped), 'card')]
    from lmdeploy_tpu_torch.models.glm4_moe import Glm4MoeModel
    route_weights = Glm4MoeModel.route_weights

    def flipped(self, w, logits, top_idx):
        cfg = self.config
        cfg.norm_topk_prob = not cfg.norm_topk_prob
        try:
            return route_weights(self, w, logits, top_idx)
        finally:
            cfg.norm_topk_prob = not cfg.norm_topk_prob
    return [('norm_topk_prob_flipped', (Glm4MoeModel, 'route_weights', flipped), 'card')]


DENSE_CONFIGS = {'gemma2_9b': GEMMA2_9B, 'glm4_9b': GLM4_9B, 'starcoder2_7b': STARCODER2_7B}
DENSE_FAMILY = {'gemma2': 'gemma2_9b', 'glm4': 'glm4_9b', 'starcoder2': 'starcoder2_7b'}
# the dense cells' depth, cut from 42 / 40 / 32 layers so that the script stays inside
# its time limit beside the earlier phases; widths, vocab and traffic as published.
# Their long prompts: past Gemma-2's and StarCoder2's window of 4,096; GLM-4-9B's as
# the other cells'; 2 since the MTP / DSA cells joined (Gemma-2's windowed and full
# layer both kept)
LDENSE = 2
DENSE_LONG = {'gemma2_9b': 6144, 'glm4_9b': 2048, 'starcoder2_7b': 6144}
# the dense parity rows (2 layers, card bf16 against CPU f32): a first card run read
# (H100 80GB HBM3, 700 W), floor (plain versions on the card) / kernels / held traps:
# Gemma-2-9B 0.235 / 0.245 / 1.86 (attention softcap left out), 530.6 (final softcap
# left out), 31.7 (norms without their +1; logits up to the cap, 30); GLM-4-9B 0.102 /
# 0.101 / 7.89 (rope in rotate-half order), 6.20 (sandwich norms left out); StarCoder2-7B
# 0.066 / 0.070 / 1.36 (LayerNorm without its bias).  Each allowance is about twice its
# floor
LOGIT_TOL_DENSE = {'gemma2_9b': 0.5, 'glm4_9b': 0.2, 'starcoder2_7b': 0.15}
# Gemma-2's seeded wq and embedding scaled so that its attention scores (std ~20) and
# logits (std ~10) reach the softcaps of 50 and 30, which the traps leave out; at the
# dense init's 0.02 neither cap moves a score or a logit
DENSE_PARITY_SCALE = {'gemma2_9b': {'wq': 16.0, 'embed': 8.0}}


def dense_config(name: str, num_layers: int = None):
    """The public config of the dense cell ``name``, depth cut to ``num_layers``."""
    from lmdeploy_tpu_torch.config import ModelConfig
    cfg = DENSE_CONFIGS[name]
    return ModelConfig.from_hf_config(
        dict(cfg, num_hidden_layers=num_layers or cfg['num_hidden_layers']))


def _dense_parity_tree(params: dict, name: str) -> dict:
    """The seeded tree with norm weights 1 + 0.1 randn and norm biases 0.1 randn, so
    that a fault that drops a norm's weight or bias shows, and the factors of
    DENSE_PARITY_SCALE applied."""
    gen = torch.Generator().manual_seed(SEED + 1)
    factors = DENSE_PARITY_SCALE.get(name, {})

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif 'norm' in k:
                noise = 0.1 * torch.randn(v.shape, generator=gen)
                out[k] = noise if k.endswith('_b') else 1.0 + noise
            else:
                out[k] = v * factors.get(k, 1.0)
        return out
    return walk(params)


def _dense_traps(name: str):
    """The dense cells' parity traps: Gemma-2's attention softcap and final softcap
    left out, and its norms without the +1 of the load; GLM-4's rope in rotate-half
    order (pairs not de-interleaved) and its sandwich norms left out; StarCoder2's
    LayerNorm without its bias."""
    from lmdeploy_tpu_torch.models import llama
    if name == 'gemma2_9b':
        attend = llama.paged_attention

        def no_softcap(*args, **kwargs):
            return attend(*args, **dict(kwargs, logit_softcap=None))

        def head_without_softcap(self, params, x):
            lm_head = params.get('lm_head')
            lm_head = params['embed'].t() if lm_head is None else lm_head
            return torch.matmul(x.float(), lm_head.float())

        def minus_one(raw):
            layers = {k: v - 1.0 if 'norm' in k else v for k, v in raw['layers'].items()}
            return dict(raw, layers=layers, final_norm=raw['final_norm'] - 1.0)
        return [('attn_softcap_left_out', (llama, 'paged_attention', no_softcap), 'card'),
                ('final_softcap_left_out', (llama.LlamaModel, '_head', head_without_softcap),
                 'card'),
                ('norm_plus_one_left_out', minus_one, 'card_params')]
    if name == 'glm4_9b':
        from lmdeploy_tpu_torch.models.glm4 import Glm4Model
        from lmdeploy_tpu_torch.nn.layers import apply_rope

        def rotate_half(self, q, k, cos, sin, layer):
            r = self.config.rope_dim
            q_rot, k_rot = apply_rope(q[..., :r], k[..., :r], cos, sin)
            return (torch.cat([q_rot, q[..., r:]], dim=-1),
                    torch.cat([k_rot, k[..., r:]], dim=-1))

        def no_sandwich(raw):
            layers = {k: v for k, v in raw['layers'].items()
                      if k not in ('post_attn_norm', 'post_mlp_norm')}
            return dict(raw, layers=layers)
        return [('rope_rotate_half', (Glm4Model, '_apply_rope', rotate_half), 'card'),
                ('sandwich_norms_left_out', no_sandwich, 'card_params')]
    from lmdeploy_tpu_torch.models import starcoder2
    from lmdeploy_tpu_torch.nn.layers import layer_norm
    return [('layer_norm_bias_left_out',
             (starcoder2, 'layer_norm', lambda x, w, b, eps: layer_norm(x, w, None, eps)),
             'card')]


# -- speculative decoding ------------------------------------------------------------
# the public config.json of yuhuili/EAGLE3-LLaMA3.1-Instruct-8B (its fields the port
# reads): one decoder layer at the target's width over a 32,000-id draft vocabulary
EAGLE3_LLAMA31_8B = {
    'architectures': ['LlamaForCausalLMEagle3'], 'model_type': 'llama',
    'hidden_size': 4096, 'intermediate_size': 14336, 'num_hidden_layers': 1,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'head_dim': 128,
    'vocab_size': 128256, 'draft_vocab_size': 32000, 'target_hidden_size': 4096,
    'max_position_embeddings': 2048, 'rms_norm_eps': 1e-05, 'rope_theta': 500000.0,
    'tie_word_embeddings': False, 'torch_dtype': 'float16',
}
# yuhuili/EAGLE-LLaMA3-Instruct-8B's EAGLE-1 head (fc over [embed ; feature], the
# target's norm and lm_head): the same layer geometry
EAGLE_LLAMA3_8B = {
    'architectures': ['LlamaForCausalLM'], 'model_type': 'llama',
    'hidden_size': 4096, 'intermediate_size': 14336, 'num_hidden_layers': 1,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'head_dim': 128,
    'vocab_size': 128256, 'max_position_embeddings': 8192, 'rms_norm_eps': 1e-05,
    'rope_theta': 500000.0, 'tie_word_embeddings': False, 'torch_dtype': 'float16',
}
# the public config.json of meta-llama/Llama-3.2-1B-Instruct, the draft model
LLAMA32_1B = {
    'architectures': ['LlamaForCausalLM'], 'model_type': 'llama',
    'hidden_size': 2048, 'intermediate_size': 8192, 'num_hidden_layers': 16,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'head_dim': 64,
    'vocab_size': 128256, 'max_position_embeddings': 131072, 'rms_norm_eps': 1e-05,
    'rope_theta': 500000.0,
    'rope_scaling': {'factor': 32.0, 'low_freq_factor': 1.0, 'high_freq_factor': 4.0,
                     'original_max_position_embeddings': 8192, 'rope_type': 'llama3'},
    'tie_word_embeddings': True, 'bos_token_id': 128000,
    'eos_token_id': [128001, 128008, 128009], 'torch_dtype': 'bfloat16',
}
# proposals a step (the reference's default)
SPEC_K = 4
# the cells over Llama-3.1-8B at L31 layers: (method, the draft's config); None: the
# target's own config and seeded weights (a self-draft)
SPEC_CELLS = {'spec_eagle3': ('eagle3', EAGLE3_LLAMA31_8B),
              'spec_draft_llama32_1b': ('draft_model', LLAMA32_1B),
              'spec_self_draft': ('draft_model', None)}
# the traffic: 63 prompts of 256 tokens and one of 2,048, 32 new tokens each (64 before
# the MTP / DSA cells joined, cut for the script's time); two of
# them seeded-sampled, one asking for its top-2 logprobs (the host-driven path)
SPEC_SAMPLED = (1, 2)
SPEC_LOGPROB_ROW = 3
SPEC_NEW = 32
# both caches' blocks (the draft's has the target's count): the traffic needs ~210 of
# 128 tokens; the 1B draft's 16 layers take 2.1 GB, as would 8 target layers
SPEC_BLOCKS = 512
# the verify (the gathered path, f32 scores over the bf16 cache) against the plain
# engine's decode (row 2's kernel) at the same positions: greedy tokens may differ only
# where the plain engine's top-2 logprob margin lies below this allowance, which must lie
# above its floor, twice the largest logit difference of the two paths on
# verify_decode_check's rows (0.2243 on an H100 80GB HBM3 at 700 W with the target at
# 8 layers of random bf16 weights; 0.25 at first, raised with the first read)
VERIFY_MARGIN_TOL = 0.3
# a head step at full width, card bf16 (the paged decode kernel) against the CPU in
# f32: the largest logit difference, which must lie within the allowance, as must the
# floor of the card's plain decode (EAGLE-1's first read 0.166, floor 0.193, on an H100
# 80GB HBM3 at 700 W, against a first allowance of 0.1: the floor is bf16's own)
HEAD_LOGIT_TOL = 0.3


def spec_config_dir(root: str, name: str, cfg: dict) -> str:
    """A directory holding ``cfg`` as config.json (the engine reads a draft's config
    from a path; its weights are seeded)."""
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    return path


def _spec_engine(target, method, draft_dir, shared, eager_mode=False):
    """An engine of the cell, its target (and a self-draft) on the seeded weights in
    ``shared``, any other draft on its own seeded weights."""
    from lmdeploy_tpu_torch.messages import SpeculativeConfig
    from lmdeploy_tpu_torch.models.llama import LlamaModel
    from lmdeploy_tpu_torch.models.mtp import MTPHead
    init = LlamaModel.init_params

    def init_target(self, *args, **kwargs):
        if isinstance(self, MTPHead):             # an MTP head: its own seeded tree
            if 'head' not in shared:
                shared['head'] = init(self, *args, **kwargs)
            return shared['head']
        if self.config.num_layers == target.num_layers and \
                self.config.hidden_size == target.hidden_size:
            if 'init' not in shared:
                shared['init'] = init(self, *args, **kwargs)
            return shared['init']
        return init(self, *args, **kwargs)
    spec = None if method is None else SpeculativeConfig(
        method=method, model=draft_dir, num_speculative_tokens=SPEC_K)
    with _swapped((LlamaModel, 'init_params', init_target)):
        return build_engine(target, 64, session_len=2048 + 128, eager_mode=eager_mode,
                            num_blocks=SPEC_BLOCKS, speculative_config=spec)


def _spec_prompts():
    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(3, 32000, size=256).tolist() for _ in range(63)]
    return prompts + [rng.randint(3, 32000, size=2048).tolist()]


def _top2_margins(out) -> list:
    """Each token's top-2 logprob margin from a request's logprobs entries."""
    margins = []
    for entry in out.logprobs:
        vals = sorted((lp.logprob for lp in entry.values()), reverse=True)
        margins.append(vals[0] - vals[1] if len(vals) > 1 else float('inf'))
    return margins


class RouteRecorder:
    """The expert choices of an eager engine's target, per (request, position): every
    forward (prefill, decode, the verify) runs in Python under ``eager_mode``, so the
    target's ``route`` sees each step's rows.  A row's request is known by its table's
    first block, which the prefill chunk that starts the request names (its first 16
    tokens are the prompt's); ``routes[(i, p)]`` holds, per MoE layer, the sorted
    choices that made position p's logits (a position the verify computes again, after
    a rejection, keeps the last: the one whose logits were used)."""

    def __init__(self, engine, prompts):
        model = engine.model_agent.model
        self.routes = {}
        self._first = {tuple(p[:16]): i for i, p in enumerate(prompts)}
        self._last = [len(p) - 1 for p in prompts]
        self._owner = {}
        forward, route = model.forward, model.route
        ctx = {}

        def recorded_forward(params, ids, positions, cache, meta, *args, **kwargs):
            ctx.update(ids=ids.cpu().numpy(), pos=positions.cpu().numpy(),
                       first=meta.block_tables[:, 0].cpu().numpy(),
                       q=meta.q_lens.cpu().numpy(), call=0)
            return forward(params, ids, positions, cache, meta, *args, **kwargs)

        def recorded_route(w, xf):
            logits, idx, wts = route(w, xf)
            self._record(ctx, idx.view(*ctx['ids'].shape, -1).sort(-1).values.cpu().numpy())
            ctx['call'] += 1
            return logits, idx, wts
        model.forward, model.route = recorded_forward, recorded_route

    def _record(self, ctx, idx):
        for r, q in enumerate(ctx['q']):
            if q <= 0:
                continue
            block = int(ctx['first'][r])
            if ctx['pos'][r, 0] == 0 and q >= 16:
                owner = self._first.get(tuple(int(t) for t in ctx['ids'][r, :16]))
                if owner is not None:
                    self._owner[block] = owner
            i = self._owner.get(block)
            if i is None:
                continue
            for t in range(int(q)):
                p = int(ctx['pos'][r, t])
                if p >= self._last[i]:
                    self.routes.setdefault((i, p), {})[ctx['call']] = tuple(idx[r, t].tolist())


def plain_differences(tokens, plain, prompts, rows, margin_tol, routes=None) -> tuple:
    """Check (b): each of ``rows`` whose tokens differ from the plain engine's, with
    the plain engine's top-2 margin at the first differing position and, where both
    engines' expert choices were recorded (``RouteRecorder``), whether they differ at
    the position whose logits chose that token.  A row passes when the margin lies below
    ``margin_tol`` or the choices differ there (a router flip: a seeded router's
    near-tie that the two paths' bf16 sums break apart, which moves the logits by up to
    a logit std, past any margin).  Returns (the differences, all passed)."""
    diffs = []
    for i in rows:
        a, b = tokens[i], plain['tokens'][i]
        j = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), None)
        if j is None:
            continue
        d = {'row': i, 'position': j, 'plain_margin': plain['margins'][i][j]}
        if routes is not None and 'routes' in plain:
            key = (i, len(prompts[i]) - 1 + j)
            mine, theirs = routes.get(key), plain['routes'].get(key)
            d['router_flip'] = None if mine is None or theirs is None else mine != theirs
        diffs.append(d)
    return diffs, all(d['plain_margin'] < margin_tol or d.get('router_flip') for d in diffs)


def acceptance_trap(target, method, draft_dir, shared, plain, margin_tol) -> dict:
    """Check (b) against a planted wrong acceptance rule: every proposal accepted and
    the target's token after the last, on an eager engine serving the first
    ACCEPT_TRAP_ROWS prompts greedy, ACCEPT_TRAP_NEW tokens each; check (b) must fail
    on its tokens."""
    from lmdeploy_tpu_torch.engine import spec_agent
    reject_sample = spec_agent.reject_sample

    def accept_every_draft(tgt, dists, draft_toks, seeds):
        out, n = reject_sample(tgt, dists, draft_toks, seeds)
        bonus = tgt[:, -1].argmax(-1)[:, None]
        return (torch.cat([draft_toks, bonus], 1).to(out.dtype),
                torch.full_like(n, draft_toks.shape[1] + 1))
    prompts = _spec_prompts()[:ACCEPT_TRAP_ROWS]
    with _swapped((spec_agent, 'reject_sample', accept_every_draft)):
        engine = _spec_engine(target, method, draft_dir, shared, eager_mode=True)
        recorder = RouteRecorder(engine, prompts)
        outs, _, _ = run_requests(engine, prompts, ACCEPT_TRAP_NEW)
        engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    diffs, within = plain_differences([o.token_ids for o in outs], plain, prompts,
                                      range(len(prompts)), margin_tol, recorder.routes)
    return {'rows': len(prompts), 'rows_differing': len(diffs),
            'rows_past_margin_without_flip': sum(
                1 for d in diffs if d['plain_margin'] >= margin_tol and not d['router_flip']),
            'caught': not within}


def spec_cell(name, method, draft_dir, target, shared, card, plain,
              fp8_layers: int = 0, margin_tol: float = VERIFY_MARGIN_TOL) -> dict:
    """One speculative cell: a graph engine (warmed at the 64-row bucket) serves the
    traffic once, counted: every speculative step must replay its graph (c) and launch
    paged_decode K x draft layers times and flash_prefill none (d; the host-driven
    row's decode steps and the prefill steps launch theirs apart); a traced run of the
    greedy requests; then an eager_mode engine of the same weights serves the traffic,
    whose tokens must equal the graph engine's, sampled and host-driven rows included
    (a); the greedy rows' tokens must equal the plain engine's but where its top-2
    margin at the first differing position lies below ``margin_tol`` or, on an MoE
    target whose plain run recorded its expert choices, where the two engines' choices
    differ at that position (b: ``plain_differences``, the eager runs' choices; a
    planted rule that accepts every proposal must fail it, ``acceptance_trap``).  A target
    with ``fp8_layers`` MoE layers of blocked-fp8 experts launches fp8_bmm three times
    a layer per chunk of the dense combine's rows (``ops/moe.py dense_row_chunk``) in
    each speculative step (the verify's B x (K+1) rows), each host-driven decode step
    and each prefill step of fewer than 768 rows (more widen the experts)."""
    from lmdeploy_tpu_torch.config import bucketize
    from lmdeploy_tpu_torch.ops.moe import QUANT_RAGGED_MIN_TOKENS, dense_row_chunk

    def combine_chunks(rows):
        E, Ie = target.num_experts, target.moe_intermediate_size
        return -(-rows // dense_row_chunk(rows, E, Ie, True))
    prompts = _spec_prompts()
    counters = _kernel_counters()
    runs = {}
    for mode in ('graphs', 'eager'):
        t0 = time.perf_counter()
        engine = _spec_engine(target, method, draft_dir, shared, eager_mode=mode == 'eager')
        build_s = time.perf_counter() - t0
        agent, spec = engine.model_agent, engine.spec
        warm = _warmed(engine, len(prompts))
        key = spec.key(bucketize(len(prompts), agent.batch_buckets))
        steps = {'spec': 0, 'host': 0, 'prefill': 0, 'fresh_prefill': 0, 'small_prefill': 0,
                 'host_chunks': 0, 'small_prefill_chunks': 0}
        emitted = []
        prefill, decode, spec_decode = agent.prefill, agent.decode, spec.spec_decode

        def counted_prefill(chunks):
            steps['prefill'] += 1
            steps['fresh_prefill'] += all(c.start == 0 for c in chunks)
            rows = (bucketize(len(chunks), agent.batch_buckets)
                    * bucketize(max(c.length for c in chunks), agent.chunk_buckets))
            if fp8_layers and rows < QUANT_RAGGED_MIN_TOKENS:
                steps['small_prefill'] += 1
                steps['small_prefill_chunks'] += combine_chunks(rows)
            return prefill(chunks)

        def counted_decode(seqs):
            steps['host'] += 1
            if fp8_layers:
                steps['host_chunks'] += combine_chunks(bucketize(len(seqs),
                                                                 agent.batch_buckets))
            return decode(seqs)

        def counted_spec(num_rows):
            out = spec_decode(num_rows)
            steps['spec'] += 1
            emitted.append(out[1][out[1] > 0])
            return out
        agent.prefill, agent.decode, spec.spec_decode = (counted_prefill, counted_decode,
                                                         counted_spec)
        for fn in counters.values():
            fn.launches = 0
            if hasattr(fn, 'combines'):
                fn.combines = 0
        agent.graphs.reset_counts()
        recorder = (RouteRecorder(engine, prompts)
                    if mode == 'eager' and 'routes' in plain else None)
        torch.cuda.reset_peak_memory_stats()
        outs, t0, t1 = run_requests(engine, prompts, SPEC_NEW, sampled=SPEC_SAMPLED,
                                    logprobs=2, logprob_rows=(SPEC_LOGPROB_ROW,))
        launches, combines = agent.graphs.launch_totals()
        agent.prefill, agent.decode, spec.spec_decode = prefill, decode, spec_decode
        run = {'tokens': [o.token_ids for o in outs], 'steps': dict(steps),
               'graphs': agent.graphs.stats(), 'build_s': build_s, 'warmup': warm,
               'eager_reason': agent.graphs.eager_reason(key),
               'launches': {n: launches[fn.__name__] for n, fn in counters.items()},
               'combines': {n: combines[fn.__name__] for n, fn in counters.items()
                            if hasattr(fn, 'combines')},
               'peak_allocated_bytes': torch.cuda.max_memory_allocated(),
               'emitted_per_step': float(np.concatenate(emitted).mean()) if emitted else None,
               'n_layers': spec.n_layers, 'bucket': key[2], 'outs': outs, 't0': t0, 't1': t1,
               'routes': None if recorder is None else recorder.routes,
               **serving_numbers({'outs': outs, 't0': t0, 't1': t1})}
        if mode == 'graphs':
            run['trace'] = profile_phase(name, engine, prompts, SPEC_NEW)
        runs[mode] = run
        engine.close()
        del engine, agent, spec, prefill, decode, spec_decode, outs, recorder
        gc.collect()
        torch.cuda.empty_cache()
    g, e = runs['graphs'], runs['eager']
    L = target.num_layers
    st = g['steps']
    need = {'paged_decode': st['spec'] * SPEC_K * g['n_layers'] + st['host'] * L,
            'flash_prefill': st['fresh_prefill'] * L}
    if fp8_layers:
        verify_rows = g['bucket'] * (SPEC_K + 1)
        need['fp8_bmm'] = 3 * fp8_layers * (st['spec'] * combine_chunks(verify_rows)
                                            + st['host_chunks'] + st['small_prefill_chunks'])
    launches_ok = all(g['launches'][k] == v and v > 0 for k, v in need.items())
    replayed = (g['graphs']['replays'] == st['spec'] > 0 and g['graphs']['eager_runs'] == 0
                and g['eager_reason'] is None)
    eager_ran_eagerly = (e['graphs']['replays'] == 0
                         and e['graphs']['eager_runs'] == e['steps']['spec'] > 0)
    equal = g['tokens'] == e['tokens']
    greedy_rows = [i for i in range(len(prompts)) if i not in SPEC_SAMPLED]
    diffs, within = plain_differences(g['tokens'], plain, prompts, greedy_rows, margin_tol,
                                      e['routes'])
    trap = (acceptance_trap(target, method, draft_dir, shared, plain, margin_tol)
            if 'routes' in plain else None)
    lengths_ok = all(len(t) == SPEC_NEW for r in runs.values() for t in r['tokens'])
    host_row = g['outs'][SPEC_LOGPROB_ROW]
    host_lp_ok = all(len(entry) >= 2 for entry in host_row.logprobs)
    row = {'phase': name, 'model': f'{model_label(target)}; speculative {method}, K '
                                   f'{SPEC_K}, draft {g["n_layers"]} layers', 'card': card,
           'requests': len(prompts), 'new_tokens': SPEC_NEW, 'sampled_rows': SPEC_SAMPLED,
           'host_driven_row': SPEC_LOGPROB_ROW,
           'steps': st, 'emitted_per_step': g['emitted_per_step'],
           'decode_tok_s': g['decode_tok_s'], 'ttft_ms': g['ttft_ms'],
           'output_tok_s': g['output_tok_s'], 'wall_s': g['wall_s'],
           'plain_decode_tok_s': plain['decode_tok_s'],
           'warmup': g['warmup'], 'graphs': g['graphs'], 'eager_reason': g['eager_reason'],
           'busy_share': g['trace']['device_busy_share'],
           'launches': g['launches'], 'combines': g['combines'], 'launches_needed': need,
           'launches_ok': launches_ok, 'replayed': replayed,
           'peak_allocated_bytes': g['peak_allocated_bytes'],
           'engine_build_s': g['build_s'], 'lengths_ok': lengths_ok,
           'host_row_top_logprobs': host_lp_ok,
           'greedy_rows_differing_from_plain': len(diffs), 'first_differences': diffs,
           'verify_margin_tol': margin_tol, 'differences_within_tol': within,
           'rows_past_margin_by_router_flip': sum(
               1 for d in diffs if d['plain_margin'] >= margin_tol and d.get('router_flip')),
           'acceptance_trap': trap, 'rows_by_kernel': {}}
    emit(row)
    check = {'phase': 'decode_graphs', 'of': name, 'card': card,
             'tokens_equal': equal, 'graphs_replayed': replayed,
             'eager_ran_eagerly': eager_ran_eagerly,
             'decode_tok_s': {'graphs': g['decode_tok_s'], 'eager': e['decode_tok_s']},
             'ttft_p50_ms': {'graphs': g['ttft_ms']['p50'], 'eager': e['ttft_ms']['p50']},
             'emitted_per_step': {'graphs': g['emitted_per_step'],
                                  'eager': e['emitted_per_step']},
             'busy_share': {'graphs': row['busy_share'], 'eager': None},
             'eager_build_s': e['build_s']}
    check['ok'] = equal and replayed and eager_ran_eagerly
    emit(check)
    if not (launches_ok and replayed and lengths_ok and within and host_lp_ok
            and (trap is None or trap['caught'])):
        raise SystemExit(f'{name} phase failed: {row}')
    if not check['ok']:
        raise SystemExit(f'decode_graphs of {name} failed: {check}')
    return row


def spec_plain_run(target, shared, card, record_routes: bool = False) -> dict:
    """The plain engine (no speculation, graphs) on the spec cells' traffic, every
    request greedy with its top-2 logprobs: its tokens and margins, and its numbers.
    With ``record_routes`` (an MoE target) an eager_mode engine serves the traffic again
    and records its expert choices (``RouteRecorder``); its tokens must equal the graph
    engine's."""
    prompts = _spec_prompts()
    engine = _spec_engine(target, None, None, shared)
    _warmed(engine, len(prompts))
    outs, t0, t1 = run_requests(engine, prompts, SPEC_NEW, logprobs=2)
    engine.close()
    row = {'phase': 'spec_plain', 'model': model_label(target), 'card': card,
           **serving_numbers({'outs': outs, 't0': t0, 't1': t1})}
    tokens = [o.token_ids for o in outs]
    routes = None
    if record_routes:
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine = _spec_engine(target, None, None, shared, eager_mode=True)
        recorder = RouteRecorder(engine, prompts)
        eager, _, _ = run_requests(engine, prompts, SPEC_NEW, logprobs=2)
        engine.close()
        routes = recorder.routes
        row['eager_tokens_equal'] = [o.token_ids for o in eager] == tokens
        del recorder, eager
    emit(row)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if record_routes and not row['eager_tokens_equal']:
        raise SystemExit(f'the plain eager engine\'s tokens are not the graph engine\'s: {row}')
    out = dict(row, tokens=tokens, margins=[_top2_margins(o) for o in outs])
    if routes is not None:
        out['routes'] = routes
    return out


def verify_decode_check(target, shared, card, tol: float = VERIFY_MARGIN_TOL,
                        name: str = 'spec_verify_vs_decode') -> dict:
    """The verify's logits (T = K+1 over history: the gathered path) against K+1 decode
    steps (row 2's kernel) from the same cache, at the same positions: 8 rows prefilled
    with 256 tokens (flash_prefill), then the chunk [argmax, 4 random proposals]; the
    largest logit difference, twice which is the floor of the margin allowance ``tol``.
    An MoE target's decode steps take the verify's expert choices (their own, counted
    beside as flips: a seeded router's near-ties flip under the two paths' bf16 sums and
    move logits by up to a logit std, as the parity phases see), so the floor holds the
    numerics."""
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    model = build_model(target)
    params = shared['init']
    B, T, BS, K1 = 8, 256, 128, SPEC_K + 1
    L, hd = target.num_layers, target.num_key_value_heads * target.cache_head_dim
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cache = torch.zeros((L, 1 + 3 * B, 2, BS, hd), dtype=torch.bfloat16, device='cuda')
    tables = (1 + torch.arange(3 * B, device='cuda', dtype=torch.int32)).reshape(B, 3)
    cos, sin = make_rope_table(target.rope_dim, 2048, target.rope_theta,
                               target.rope_scaling, device='cuda')
    ids = torch.randint(3, 32000, (B, T), generator=gen, device='cuda', dtype=torch.int32)
    pos = torch.arange(T, device='cuda', dtype=torch.int32)[None].expand(B, T).contiguous()
    # the verify's expert choices per MoE layer call, replayed by each decode step
    routes = {'mode': None, 'verify': [], 'calls': 0, 'flips': 0}
    if hasattr(model, 'route'):
        route = model.route

        def routed(w, xf):
            logits, idx, wts = route(w, xf)
            if routes['mode'] == 'record':
                routes['verify'].append(idx.view(B, K1, -1))
            elif routes['mode'] is not None:
                n = len(routes['verify'])
                forced = routes['verify'][routes['calls'] % n][:, routes['calls'] // n]
                routes['calls'] += 1
                if routes['mode'] == 'count':
                    routes['flips'] += int((forced.sort(-1).values
                                            != idx.sort(-1).values).any(-1).sum())
                idx, wts = forced, model.route_weights(w, logits, forced)
            return logits, idx, wts
        model.route = routed

    def meta(hist, q):
        return AttnMeta(tables, torch.full((B,), hist, dtype=torch.int32, device='cuda'),
                        torch.full((B,), q, dtype=torch.int32, device='cuda'))

    def decode_steps(mode):
        routes.update(mode=mode, calls=0)
        cache.copy_(base)
        out = []
        for j in range(K1):
            p = torch.full((B, 1), T + j, dtype=torch.int32, device='cuda')
            out.append(model.forward(params, chunk[:, j:j + 1].contiguous(), p, cache,
                                     meta(T + j, 1), cos, sin))
        return torch.stack(out, 1)
    with torch.no_grad():
        last = model.forward(params, ids, pos, cache, meta(0, T), cos, sin, fresh_prefill=True)
        chunk = torch.cat([last.argmax(-1).int()[:, None],
                           torch.randint(3, 32000, (B, SPEC_K), generator=gen, device='cuda',
                                         dtype=torch.int32)], dim=1)
        base = cache.clone()
        routes['mode'] = 'record'
        p = (T + torch.arange(K1, device='cuda', dtype=torch.int32))[None].expand(B, K1)
        ver = model.forward(params, chunk, p.contiguous(), cache, meta(T, K1), cos, sin,
                            return_all_logits=True)
        dec = decode_steps('count')
        # the same decode steps on the plain decode: the floor's share that is the
        # verify's GEMM shapes and f32 scores, not the kernel
        with _plain_kernels():
            plain = decode_steps('force')
    diff = (ver - dec).abs()
    floor = 2 * diff.max().item()
    row = {'phase': name, 'card': card, 'rows': B, 'history': T,
           'positions': K1, 'layers': L, 'max_abs_logit_diff': diff.max().item(),
           'mean_abs_logit_diff': diff.mean().item(), 'floor': floor,
           'plain_decode_max_abs_logit_diff': (ver - plain).abs().max().item(),
           'kernel_vs_plain_decode_max_abs_logit_diff': (dec - plain).abs().max().item(),
           'logit_std': ver.std().item(),
           'verify_margin_tol': tol,
           'argmax_equal_share': (ver.argmax(-1) == dec.argmax(-1)).float().mean().item(),
           'ok': bool(torch.isfinite(ver).all()) and floor <= tol}
    if routes['verify']:
        row.update(routing='decode steps take the verify\'s expert choices',
                   decode_rows_whose_own_choices_flip=routes['flips'])
    emit(row)
    del cache, base, ver, dec, plain, diff
    gc.collect()
    torch.cuda.empty_cache()       # the engines' graph pools cannot reuse cached blocks
    if not row['ok']:
        raise SystemExit(f'the verify disagrees with the decode past the allowance: {row}')
    return row


def spec_sampler_check(card) -> dict:
    """reject_sample and advance_rows on the card against the CPU, exactly, at the
    cells' shape (B 64, K 4, V 128,256) with planted distributions and uniforms: rows
    whose draft is the target (all accepted), rows whose first acceptance uniform is
    0.999999 (first rejected), the rest random (partial); then the row advance."""
    from lmdeploy_tpu_torch.engine.spec_agent import advance_rows
    from lmdeploy_tpu_torch.ops.sampling import hash_uniform
    from lmdeploy_tpu_torch.ops.spec_sampling import draw, reject_sample
    B, K, V, F = 64, SPEC_K, 128256, 4096
    gen = torch.Generator().manual_seed(SEED)
    target = torch.softmax(torch.randn(B, K + 1, V, generator=gen) * 3, -1)
    draft = torch.softmax(torch.randn(B, K, V, generator=gen) * 3, -1)
    draft[:16] = target[:16, :K]
    # drafts half the target's: accepted about half the time (partial rows)
    draft[32:] = 0.5 * (draft[32:] + target[32:, :K])
    seeds = torch.arange(B, dtype=torch.int64) * 7919
    tokens = torch.stack([draw(draft[:, i], hash_uniform(seeds + i, V, 5)) for i in range(K)], 1)
    u_acc = torch.rand(B, K, generator=gen).clamp_min(1e-6)
    u_acc[16:32, 0] = 0.999999
    u_res = torch.rand(B, V, generator=gen).clamp_min(1e-6)
    u_bon = torch.rand(B, V, generator=gen).clamp_min(1e-6)
    args = (target, draft, tokens)
    cpu = reject_sample(*args, uniforms=(u_acc, u_res, u_bon))
    card_out = reject_sample(*(a.cuda() for a in args),
                             uniforms=tuple(u.cuda() for u in (u_acc, u_res, u_bon)))
    torch.cuda.synchronize()
    emitted = cpu[1].tolist()
    sample_equal = all(torch.equal(c.cpu(), r) for c, r in zip(card_out, cpu))

    def advanced(device):
        out, n = (t.to(device) for t in cpu)
        g = torch.Generator().manual_seed(SEED + 1)
        row = {'active': (torch.arange(B) % 9 != 4).to(device),
               'token': torch.randint(0, V, (B,), generator=g, dtype=torch.int32).to(device),
               'position': torch.randint(0, 2000, (B,), generator=g, dtype=torch.int32).to(device),
               'step_no': torch.randint(0, 60, (B,), generator=g, dtype=torch.int32).to(device)}
        n = torch.where(row['active'], n, torch.zeros_like(n))
        counts = torch.randint(0, 3, (B + 1, V), generator=g, dtype=torch.int32).to(device)
        hidden = torch.randn(B, F, generator=g).to(torch.bfloat16).to(device)
        feats = torch.randn(B, K + 1, F, generator=g).to(torch.bfloat16).to(device)
        advance_rows(row, counts[:B], out, n, hidden, feats)
        return [t.cpu() for t in (*row.values(), counts, hidden)]
    advance_equal = all(torch.equal(a, b) for a, b in zip(advanced('cuda'), advanced('cpu')))
    row = {'phase': 'spec_sampler', 'card': card, 'shape': [B, K, V],
           'all_accepted_rows': sum(e == K + 1 for e in emitted),
           'first_rejected_rows': sum(e == 1 for e in emitted),
           'partial_rows': sum(1 < e < K + 1 for e in emitted),
           'reject_sample_equal': sample_equal, 'advance_rows_equal': advance_equal}
    row['ok'] = (sample_equal and advance_equal and row['all_accepted_rows'] >= 16
                 and row['first_rejected_rows'] >= 16 and row['partial_rows'] > 0)
    emit(row)
    if not row['ok']:
        raise SystemExit(f'the speculative sampler on the card is not the CPU\'s: {row}')
    return row


def spec_heads_check(target, shared, card) -> dict:
    """EAGLE-1 and EAGLE-3 head steps at their published widths, 16 rows and two chained
    steps over a head cache of random stale pages: the card in bf16 (the paged decode
    kernel, and the plain decode for the floor) against the CPU in f32 (the same seeded
    weights and inputs), by the largest logit and feature difference."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models.eagle import Eagle3Head, EagleHead
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    tparams = {k: shared['init'][k] for k in ('embed', 'final_norm', 'lm_head')}
    B, BS, W, NB = 16, 128, 17, 1 + 16 * 17
    rows = []
    for kind, cfg_dict, cls in (('eagle', EAGLE_LLAMA3_8B, EagleHead),
                                ('eagle3', EAGLE3_LLAMA31_8B, Eagle3Head)):
        cfg = ModelConfig.from_hf_config(cfg_dict, dtype='bfloat16')
        head = cls(cfg)
        params = head.init_params(SEED, device='cuda')
        gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
        hd = cfg.num_key_value_heads * cfg.head_dim
        cache = (torch.randn((1, NB, 2, BS, hd), generator=gen, device='cuda') * 0.5
                 ).to(torch.bfloat16)
        tables = (1 + torch.arange(B * W, device='cuda', dtype=torch.int32)).reshape(B, W)
        pos = torch.randint(100, 2000, (B,), generator=gen, device='cuda', dtype=torch.int32)
        q1 = torch.ones(B, dtype=torch.int32, device='cuda')
        q1[-1] = 0
        # each step's tokens (the same on both sides, whatever either side's argmax)
        toks = torch.randint(3, 32000, (2, B), generator=gen, device='cuda', dtype=torch.int32)
        width = 3 * head.target_hidden if kind == 'eagle3' else cfg.hidden_size
        feat = torch.randn((B, width), generator=gen, device='cuda').to(torch.bfloat16)

        def steps(device, dtype, plain=False):
            def mv(t):
                return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
            p = {k: mv(v) for k, v in params.items()}
            tp = {k: mv(v) for k, v in tparams.items()}
            c, ps = mv(cache), pos.to(device)
            cos, sin = make_rope_table(target.rope_dim, 2048 + 128, target.rope_theta,
                                       target.rope_scaling, device=device)
            h = mv(feat)
            if kind == 'eagle3':
                h = head.condition(p, h, dtype)
            out = []
            with _plain_kernels() if plain else contextlib.nullcontext():
                for t in toks.to(device):
                    logits, h = head.step(p, p['embed'] if kind == 'eagle3' else tp, h, t,
                                          ps, c, tables.to(device), q1.to(device), cos, sin,
                                          2048 + 128)
                    out.append((logits.float().cpu(), h.float().cpu()))
                    ps = ps + q1.to(device)
            return out
        ref = steps('cpu', torch.float32)
        got = steps('cuda', torch.bfloat16)
        floor = steps('cuda', torch.bfloat16, plain=True)
        act = slice(0, B - 1)

        def err(a, i):
            return max((a[s][i][act] - ref[s][i][act]).abs().max().item() for s in range(2))
        row = {'phase': 'spec_head_step', 'head': kind, 'card': card,
               'shape': {'rows': B, 'hidden': cfg.hidden_size, 'heads': [cfg.num_attention_heads,
                         cfg.num_key_value_heads, cfg.head_dim],
                         'vocab': head.draft_vocab if kind == 'eagle3' else cfg.vocab_size},
               'max_abs_logit_err': err(got, 0), 'floor_logit_err': err(floor, 0),
               'max_abs_feature_err': err(got, 1), 'floor_feature_err': err(floor, 1),
               'logit_tol': HEAD_LOGIT_TOL,
               'logit_std': float(np.mean([ref[s][0][act].std().item() for s in range(2)])),
               'argmax_equal_cpu_share': float(np.mean([
                   (got[s][0][act].argmax(-1) == ref[s][0][act].argmax(-1)).float().mean()
                   for s in range(2)]))}
        row['ok'] = (row['max_abs_logit_err'] <= HEAD_LOGIT_TOL
                     and row['floor_logit_err'] <= HEAD_LOGIT_TOL
                     and all(np.isfinite([row['max_abs_logit_err'], row['max_abs_feature_err']])))
        emit(row)
        rows.append(row)
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()
        if not row['ok']:
            raise SystemExit(f'the {kind} head step on the card is off the CPU: {row}')
    return rows


def spec_phase(card: str) -> dict:
    """Speculative decoding on Llama-3.1-8B (L31 layers, seeded bf16 weights shared by
    every engine): the sampler and head checks, the verify against the decode, the plain
    engine's run, then each cell of SPEC_CELLS (``spec_cell``).  Returns the cells'
    rows by name."""
    import tempfile
    target = llama31_config(L31)
    shared = {}
    root = tempfile.mkdtemp(prefix='spec_configs_')
    try:
        spec_sampler_check(card)
        plain = spec_plain_run(target, shared, card)
        verify_decode_check(target, shared, card)
        spec_heads_check(target, shared, card)
        paths = {}
        for name, (method, cfg) in SPEC_CELLS.items():
            draft = cfg if cfg is not None else dict(LLAMA31_8B, num_hidden_layers=L31)
            paths[name] = spec_cell(name, method, spec_config_dir(root, name, draft), target,
                                    shared, card, plain)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shared.clear()
    return paths


# -- MTP speculative decoding on DeepSeek-V3, and DeepSeek Sparse Attention -----------
# the public config.json of deepseek-ai/DeepSeek-V3.2-Exp: V3's fields plus the lightning
# indexer's (64 heads of 128, top 2,048)
DEEPSEEK_V32 = dict(DEEPSEEK_V3, architectures=['DeepseekV32ForCausalLM'],
                    model_type='deepseek_v32', index_n_heads=64, index_head_dim=128,
                    index_topk=2048)
# the V3 / V3.2 cells' depth, cut from 61 layers: the 3 dense layers and one MoE layer of
# seeded blocked-fp8 experts (plus V3's MTP layer in the speculative cell); width,
# experts, vocab and the indexer stay as published
LV3 = 4
# an MTP head step at full width in bf16 against the same step in f32 (DeepSeek-V3's on
# the card, its 256 f32 experts being 45 GB; GLM-4.5-Air's on the host): the largest
# logit difference, as HEAD_LOGIT_TOL holds the EAGLE heads
MTP_LOGIT_TOL = 0.3
MTP_STEP_ROWS = 16
# the greedy prompts that acceptance_trap serves and their new tokens (two speculative
# steps: the first wrong proposal is the step's first)
ACCEPT_TRAP_ROWS = 24
ACCEPT_TRAP_NEW = 2 * (SPEC_K + 1)
# V3.2's first two layers (both dense) over one 4,096-token prompt, bf16 on the card
# against f32: the largest difference of the last position's logits (the bf16 run on
# the f32 run's picks), and of each layer's top-2,048 picks the ones that differ, each
# the f32 side's boundary deficit (score of its last pick minus the pick's score) over
# the row's score spread, the bf16 run on the f32 run's picks so that each layer's inputs
# stay within rounding of the f32 side's.  First allowances 0.1 and 0.02, raised with the
# first reads (H100 80GB HBM3, 700 W): logits 0.1098 (std 1.69), deficits 0.029 (layer
# 0) and 0.1427 (layer 1, whose inputs carry layer 0's rounding); the planted traps' picks
# read 5.3-5.4 spreads
DSA_PARITY_LEN = 4096
DSA_LOGIT_TOL = 0.3
DSA_PICK_TOL = 0.5
# e2e_deepseek_v32_fp8's traffic: 24 prompts of 1,024 tokens and 8 of 4,096, 32 greedy
# tokens each
V32_TRAFFIC = ((24, 1024), (8, 4096))
V32_NEW = 32
# its cache: the traffic's ~460 blocks of 128 tokens, with room (a cache sized from free
# memory would leave no room for the MoE layer's widened experts at prefill)
V32_BLOCKS = 640


def v3_config(cfg: dict, num_layers: int = LV3, dtype: str = 'auto', **over):
    """A ModelConfig of a DeepSeek public config at ``num_layers`` (with ``over``), the
    registry's fields set (one latent kv head, the DSA cache sidecar)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    config = ModelConfig.from_hf_config(dict(cfg, num_hidden_layers=num_layers, **over),
                                        dtype=dtype)
    build_model(config)
    return config


def _v3_tree(shared: dict):
    """DeepSeek-V3's seeded tree at LV3 layers (bf16, blocked-fp8 routed experts), made
    once and shared by the V3 and V3.2 cells."""
    from lmdeploy_tpu_torch.models.deepseek import DeepseekV2Model
    if 'v3' not in shared:
        shared['v3'] = DeepseekV2Model(v3_config(DEEPSEEK_V3)).init_params(SEED, 'cuda')
    return shared['v3']


def _seeded_by_matrix(model, seed: int) -> dict:
    """``model``'s seeded bf16 tree drawn one [K, N] matrix at a time (norms ones, norm
    biases zeros, the rest std 0.02): ``init_params`` draws a whole leaf in f32 and scales
    it, ~28 GB of temporaries for one of DeepSeek-V3's MTP expert stacks."""
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def walk(shapes):
        out = {}
        for name, shape in shapes.items():
            if isinstance(shape, dict):
                out[name] = walk(shape)
            elif 'norm' in name:
                fill = torch.zeros if name.endswith('_b') else torch.ones
                out[name] = fill(shape, dtype=torch.bfloat16, device='cuda')
            else:
                t = torch.empty(shape, dtype=torch.bfloat16, device='cuda')
                for m in t.view(-1, *shape[-2:]) if len(shape) > 2 else [t]:
                    m.copy_(torch.randn(m.shape, generator=gen, device='cuda') * 0.02)
                out[name] = t
        return out
    return walk(model.param_shapes())


def _with_indexer(tree: dict, model, seed: int = SEED + 7) -> dict:
    """``tree`` (V3's) with the indexer leaves of ``model`` seeded on: the groups are new
    dicts over the same tensors."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    out = dict(tree)
    for group, shapes in model.param_shapes().items():
        if not isinstance(shapes, dict) or group not in tree:
            continue
        g = dict(tree[group])
        for name, shape in shapes.items():
            if name.startswith('idx_') and name not in g:
                if 'norm' in name:
                    fill = torch.zeros if name.endswith('_b') else torch.ones
                    g[name] = fill(shape, dtype=torch.bfloat16, device='cuda')
                else:
                    g[name] = (torch.randn(shape, generator=gen, device='cuda') * 0.02
                               ).to(torch.bfloat16)
        out[group] = g
    return out


def _to(tree, dtype, device='cuda', pop: bool = False):
    """``tree``'s floating leaves in ``dtype`` on ``device`` (with ``pop``, each source
    leaf is dropped as it is converted, so a tree is never held twice)."""
    out = {}
    for k in list(tree):
        v = tree.pop(k) if pop else tree[k]
        if isinstance(v, dict):
            out[k] = _to(v, dtype, device, pop)
        else:
            out[k] = v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
        del v
    return out


def mtp_step_check(card: str) -> list:
    """mtp_step: each MTP head's step at full width, 16 rows (the last inactive) and two
    chained steps over a head cache of random stale pages: DeepSeek-V3's in bf16 on the
    card (row 2's paged decode at Hq 128, D 576) against f32 on the card through the
    plain versions (its 256 f32 experts do not fit a host comparison), GLM-4.5-Air's in
    bf16 (row 2 at Hq 96, Hkv 8, D 128) against f32 on the host; each also in bf16
    through the plain versions, the floor.  The f32 step runs first and the bf16 steps
    take its expert choices (their own, recorded beside: flips at near-tied random
    router scores would otherwise swamp the numerics, as in the parity phases); the
    largest logit difference must lie within MTP_LOGIT_TOL."""
    from lmdeploy_tpu_torch.models.mtp import DeepseekMTP, Glm4MoeMTP
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    B, BS, W = MTP_STEP_ROWS, 128, 17
    NB = 1 + B * W
    max_len = 4096 + 128
    rows = []
    for name, cfg_dict, cls, ref_device in (('deepseek_v3', DEEPSEEK_V3, DeepseekMTP, 'cuda'),
                                            ('glm45_air', GLM45_AIR, Glm4MoeMTP, 'cpu')):
        cfg = v3_config(cfg_dict, cfg_dict['num_hidden_layers'])
        head = cls(cfg)
        H, V = cfg.hidden_size, cfg.vocab_size

        def seeded():
            """The head's and the target's seeded bf16 weights (the same at every call)."""
            gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
            tp = {k: (torch.randn(shape, generator=gen, device='cuda') * 0.02
                      ).to(torch.bfloat16) for k, shape in (('embed', (V, H)),
                                                            ('lm_head', (H, V)))}
            return head.init_params(SEED, device='cuda'), tp
        gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
        cache = (torch.randn((1, NB, 2, BS, head.cache_width), generator=gen, device='cuda')
                 * 0.5).to(torch.bfloat16)
        tables = (1 + torch.arange(B * W, device='cuda', dtype=torch.int32)).reshape(B, W)
        pos = torch.randint(100, 2000, (B,), generator=gen, device='cuda', dtype=torch.int32)
        q1 = torch.ones(B, dtype=torch.int32, device='cuda')
        q1[-1] = 0
        toks = torch.randint(3, 32000, (2, B), generator=gen, device='cuda', dtype=torch.int32)
        feat = torch.randn((B, H), generator=gen, device='cuda').to(torch.bfloat16)
        # the f32 step's expert choices, replayed by the bf16 steps; their own beside
        routes = {'ref': [], 'own': []}
        mode = {'force': False, 'record_own': False, 'j': 0}
        route = head.route

        def routed(w, xf):
            logits, idx, wts = route(w, xf)
            scores = head.choice_scores(w, logits).float().cpu()
            if not mode['force']:
                routes['ref'].append((scores, idx.cpu()))
                return logits, idx, wts
            if mode['record_own']:
                routes['own'].append((scores, idx.cpu()))
            idx = routes['ref'][mode['j']][1].to(idx.device)
            mode['j'] += 1
            return logits, idx, head.route_weights(w, logits, idx)
        head.route = routed

        def steps(p, tp, device, dtype, plain=False):
            mode['j'] = 0
            c, ps, h = cache.to(device, dtype).clone(), pos.to(device), feat.to(device, dtype)
            cos, sin = make_rope_table(cfg.rope_dim, max_len, cfg.rope_theta,
                                       cfg.rope_scaling, device=device)
            out = []
            with _plain_kernels() if plain else contextlib.nullcontext():
                for t in toks.to(device):
                    logits, h = head.step(p, tp, h, t, ps, c, tables.to(device),
                                          q1.to(device), cos, sin, max_len)
                    out.append((logits.float().cpu(), h.float().cpu()))
                    ps = ps + q1.to(device)
            return out
        params, tparams = seeded()
        ref = steps(_to(params, torch.float32, ref_device, pop=True),
                    _to(tparams, torch.float32, ref_device, pop=True), ref_device,
                    torch.float32, plain=ref_device == 'cuda')
        gc.collect()
        torch.cuda.empty_cache()
        params, tparams = seeded()
        mode.update(force=True, record_own=True)
        counters = _kernel_counters()
        counters['paged_decode'].launches = 0
        got = steps(params, tparams, 'cuda', torch.bfloat16)
        launches = counters['paged_decode'].launches
        mode['record_own'] = False
        floor = steps(params, tparams, 'cuda', torch.bfloat16, plain=True)
        del head.route
        act = slice(0, B - 1)
        flips = sum(int((ri.sort(-1).values != oi.sort(-1).values).any(-1)[act].sum())
                    for (_, ri), (_, oi) in zip(routes['ref'], routes['own']))
        router_err = max((os_ - rs).abs().max().item()
                         for (rs, _), (os_, _) in zip(routes['ref'], routes['own']))

        def err(a, i):
            return max((a[s][i][act] - ref[s][i][act]).abs().max().item() for s in range(2))
        row = {'phase': 'mtp_step', 'head': name, 'card': card,
               'reference': f'f32 on the {"card, plain versions" if ref_device == "cuda" else "host"}',
               'shape': {'rows': B, 'hidden': H, 'heads': [cfg.num_attention_heads,
                         1 if cls is DeepseekMTP else cfg.num_key_value_heads,
                         head.cache_width if cls is DeepseekMTP else cfg.head_dim],
                         'experts': cfg.num_experts, 'vocab': V},
               'paged_decode_launches': launches,
               'routing': 'bf16 steps take the f32 step\'s expert choices',
               'rows_whose_own_choices_flip': flips, 'router_score_err_max': router_err,
               'max_abs_logit_err': err(got, 0), 'floor_logit_err': err(floor, 0),
               'max_abs_feature_err': err(got, 1), 'floor_feature_err': err(floor, 1),
               'logit_tol': MTP_LOGIT_TOL,
               'logit_std': float(np.mean([ref[s][0][act].std().item() for s in range(2)])),
               'argmax_equal_ref_share': float(np.mean([
                   (got[s][0][act].argmax(-1) == ref[s][0][act].argmax(-1)).float().mean()
                   for s in range(2)]))}
        row['ok'] = (row['max_abs_logit_err'] <= MTP_LOGIT_TOL and launches == 2
                     and row['floor_logit_err'] <= MTP_LOGIT_TOL
                     and all(np.isfinite([row['max_abs_logit_err'],
                                          row['max_abs_feature_err']])))
        emit(row)
        rows.append(row)
        del params, tparams, cache, got, floor, ref
        gc.collect()
        torch.cuda.empty_cache()
        if not row['ok']:
            raise SystemExit(f'the {name} MTP head step is off its f32 step: {row}')
    return rows


def _dsa_traps(glm: bool):
    """[(trap, swaps)]: the indexer's rope in the other pair order, the Hadamard left
    out of the cached keys (out of both q and k it changes nothing but rounding: the
    transform is orthogonal), ties to the higher index."""
    from lmdeploy_tpu_torch.models import deepseek_v32
    from lmdeploy_tpu_torch.models.deepseek import _deinterleave
    from lmdeploy_tpu_torch.models.glm_moe_dsa import GlmMoeDsaModel
    from lmdeploy_tpu_torch.nn.layers import apply_rope
    hadamard = deepseek_v32.hadamard_transform
    cls = GlmMoeDsaModel if glm else deepseek_v32.DeepseekV32Model

    def other_order(self, x, cos, sin):
        d = x if not glm else _deinterleave(x)
        return apply_rope(d, d, cos, sin)[0]
    def keys_unrotated(x):
        # the block rotates the key (a [B, T, Di] row) before the queries ([.., hI, Di])
        return x if x.dim() == 3 else hadamard(x)

    def ties_high(x):
        n = x.shape[-1]
        return n - 1 - torch.sort(x.flip(-1), dim=-1, descending=True, stable=True).indices
    return [('indexer_rope_other_order', [(cls, '_indexer_rope', other_order)]),
            ('hadamard_left_out_of_keys', [(deepseek_v32, 'hadamard_transform', keys_unrotated)]),
            ('ties_to_higher_index', [(deepseek_v32, '_sorted_desc', ties_high)])]


def _dsa_run(model, params, ids, record_scores: bool = False, force=None):
    """One fresh prefill of ``ids`` [1, T] through ``model`` on the card: (the last
    position's logits, each layer's own picks [T, K], valid [T, K] and, with
    ``record_scores``, its score rows [T, S] f32); ``force``: another run's picks, taken
    in place of the model's own (which are still returned)."""
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    cfg = model.config
    T, BS = ids.shape[1], 128
    W = -(-T // BS) + 1
    dtype = params['embed'].dtype
    cache = torch.zeros((cfg.num_layers, 1 + W, 2, BS, cfg.cache_head_dim), dtype=dtype,
                        device='cuda')
    cos, sin = make_rope_table(cfg.rope_dim, W * BS, cfg.rope_theta, cfg.rope_scaling,
                               device='cuda')
    meta = AttnMeta(1 + torch.arange(W, dtype=torch.int32, device='cuda')[None],
                    torch.zeros(1, dtype=torch.int32, device='cuda'),
                    torch.full((1,), T, dtype=torch.int32, device='cuda'))
    picks, scores = [], []
    select, score = model._dsa_select, model._dsa_scores

    def recorded_select(*args):
        out = select(*args)
        picks.append((out[0][0], out[1][0]))      # the model's own
        if force is not None:
            fp, fv = (t[None] for t in force[len(picks) - 1])
            out = (fp, fv, (fp, fv) if isinstance(out[2], tuple) else out[2])
        return out

    def recorded_scores(*args):
        out = score(*args)
        scores.append(out[0])
        return out
    model._dsa_select = recorded_select
    if record_scores:
        model._dsa_scores = recorded_scores
    try:
        with torch.no_grad():
            pos = torch.arange(T, dtype=torch.int32, device='cuda')[None]
            logits = model.forward(params, ids, pos, cache, meta, cos, sin, fresh_prefill=True)
    finally:
        del model._dsa_select
        if record_scores:
            del model._dsa_scores
    # a layer's score rows come in query blocks, in order; one layer's blocks cover T
    rows, per_layer = [], []
    for blk in scores:
        per_layer.append(blk)
        if sum(b.shape[0] for b in per_layer) == T:
            rows.append(torch.cat(per_layer))
            per_layer = []
    return logits[0].float(), picks, rows


def _pick_check(card_picks, ref_picks, ref_scores) -> dict:
    """Layer by layer: the card's valid picks that the f32 side did not pick, each with
    the f32 side's boundary deficit over its score spread; and whether each row's
    invalid picks (past the causal range) are the f32 side's, in its order."""
    out = []
    for (cp, cv), (rp, rv), sc in zip(card_picks, ref_picks, ref_scores):
        T, K = rp.shape
        ref_set = torch.zeros_like(sc, dtype=torch.bool).scatter_(1, rp, rv)
        extra = cv & ~torch.gather(ref_set, 1, cp)              # card-only valid picks
        finite = torch.where(torch.isfinite(sc), sc, torch.zeros_like(sc))
        spread = finite.std(-1, keepdim=True).clamp_min(1e-30)
        last = torch.gather(rp, 1, (rv.sum(-1, keepdim=True) - 1).clamp(min=0))
        kth = torch.gather(sc, 1, last)                       # the f32 side's last pick
        deficit = ((kth - torch.gather(sc, 1, cp)) / spread).masked_fill(~extra, 0.0)
        invalid_equal = bool(((cv == rv) & torch.where(~rv, cp == rp, True)).all())
        out.append({'differing_picks': int(extra.sum()), 'queries': T, 'k': K,
                    'rows_with_differences': int(extra.any(-1).sum()),
                    'max_deficit_over_spread': float(deficit.max()),
                    'invalid_picks_equal': invalid_equal})
    return {'layers': out,
            'max_deficit_over_spread': max(o['max_deficit_over_spread'] for o in out),
            'invalid_picks_equal': all(o['invalid_picks_equal'] for o in out)}


def dsa_parity_phase(card: str, shared: dict) -> list:
    """parity_deepseek_v32 (and parity_glm_moe_dsa_v32_widths: the same widths and weights
    with indexer_types ['full', 'shared'] and rotate-half indexer rope, GLM-MoE-DSA's
    path; GLM-5's config is not in the repository): V3.2's first two layers (both dense)
    over one 4,096-token prompt, so the top-2,048 selection is sparse for the last 2,048
    queries; bf16 on the card against f32 on the card through the plain versions (a
    4,096-token f32 forward of two full-width layers takes tens of seconds on the host):
    the last position's logits within DSA_LOGIT_TOL with the f32 run's picks (the card's
    own beside), and each card pick the f32 side did not make within DSA_PICK_TOL of its
    boundary; each trap of ``_dsa_traps`` must break the picks check."""
    from lmdeploy_tpu_torch.models import build_model
    rng = np.random.RandomState(SEED + 11)
    ids = torch.from_numpy(rng.randint(3, 32000, size=(1, DSA_PARITY_LEN))).int().cuda()
    rows = []
    base = _v3_tree(shared)
    for name, over in (('parity_deepseek_v32', {}),
                       ('parity_glm_moe_dsa_v32_widths',
                        dict(architectures=['GlmMoeDsaForCausalLM'], model_type='glm_moe_dsa',
                             indexer_types=['full', 'shared']))):
        over = dict(over, first_k_dense_replace=2)
        cfg = v3_config(dict(DEEPSEEK_V32, **over), 2)
        model = build_model(cfg)
        model32 = build_model(v3_config(dict(DEEPSEEK_V32, **over), 2, dtype='float32'))
        two = {'embed': base['embed'], 'final_norm': base['final_norm'],
               'lm_head': base['lm_head'],
               'layers': {k: v[:2] for k, v in base['layers'].items()}}
        p16 = _with_indexer(two, model)
        p32 = _to(p16, torch.float32)
        with _plain_kernels():
            ref_logits, ref_picks, ref_scores = _dsa_run(model32, p32, ids, record_scores=True)
        del p32
        logits, _, _ = _dsa_run(model, p16, ids)
        # the bf16 run on the f32 run's picks: each layer's inputs stay within rounding
        # of the f32 side's, so its own picks show the selection's own error
        forced, picks, _ = _dsa_run(model, p16, ids, force=ref_picks)
        picks_row = _pick_check(picks, ref_picks, ref_scores)
        traps = {}
        for trap, swaps in _dsa_traps(name != 'parity_deepseek_v32'):
            with _swapped(*swaps):
                _, t_picks, _ = _dsa_run(model, p16, ids, force=ref_picks)
            tc = _pick_check(t_picks, ref_picks, ref_scores)
            traps[trap] = {'max_deficit_over_spread': tc['max_deficit_over_spread'],
                           'invalid_picks_equal': tc['invalid_picks_equal']}
            traps[trap]['caught'] = (tc['max_deficit_over_spread'] > DSA_PICK_TOL
                                     or not tc['invalid_picks_equal'])
        row = {'phase': name, 'card': card, 'model': f'{cfg.hf_arch} widths, 2 dense layers',
               'prompt_tokens': DSA_PARITY_LEN, 'index_topk': model.idx_topk,
               'indexer_types': [('full' if f else 'shared') for f in model.idx_full]
               if hasattr(model, 'idx_full') else None,
               'max_abs_logit_err': (forced - ref_logits).abs().max().item(),
               'picks': 'the bf16 run takes the f32 run\'s picks; its own beside',
               'own_picks_max_abs_logit_err': (logits - ref_logits).abs().max().item(),
               'logit_std': ref_logits.std().item(), 'logit_tol': DSA_LOGIT_TOL,
               'argmax_equal': bool(logits.argmax() == ref_logits.argmax()),
               'own_picks_on_f32_inputs': picks_row, 'pick_tol': DSA_PICK_TOL,
               'traps': traps}
        row['ok'] = (row['max_abs_logit_err'] <= DSA_LOGIT_TOL
                     and picks_row['max_deficit_over_spread'] <= DSA_PICK_TOL
                     and picks_row['invalid_picks_equal']
                     and all(t['caught'] for t in traps.values()))
        emit(row)
        rows.append(row)
        del p16, ref_scores, ref_picks, picks
        gc.collect()
        torch.cuda.empty_cache()
        if not row['ok']:
            raise SystemExit(f'{name} failed: {row}')
    return rows


def spec_mtp_phase(card: str, shared: dict) -> dict:
    """spec_mtp_deepseek_v3: DeepSeek-V3 at full width, its LV3 layers (3 dense, 1 MoE of
    seeded blocked-fp8 experts) and its MTP layer (seeded with the reference's dense
    expert shapes), bf16 MLA cache, K = SPEC_K, the speculative cells' traffic
    (``spec_cell``): per speculative step paged_decode K times (the head's MLA at D 576)
    and fp8_bmm 3 times a chunk of the verify's 320 rows in the MoE layer's dense
    combine (16 chunks of 20); per host-driven step 4 and 3; per fresh prefill step
    flash_prefill 4 times; the greedy rows against the plain engine's under
    VERIFY_MARGIN_TOL, whose floor ``verify_decode_check`` reads first, past it only at
    a router flip (the one MoE layer is the last, so a choice at a position moves that
    position's logits and no other's)."""
    from lmdeploy_tpu_torch.models.mtp import DeepseekMTP
    target = v3_config(DEEPSEEK_V3)
    # the head's 22.5 GB of dense bf16 experts, seeded without init_params' f32
    # temporaries beside the target's 19 GB
    spec_shared = {'init': _v3_tree(shared),
                   'head': _seeded_by_matrix(DeepseekMTP(target), SEED + 9)}
    try:
        plain = spec_plain_run(target, spec_shared, card, record_routes=True)
        verify_decode_check(target, spec_shared, card, VERIFY_MARGIN_TOL,
                            'spec_mtp_verify_vs_decode')
        return spec_cell('spec_mtp_deepseek_v3', 'deepseek_mtp', None, target, spec_shared,
                         card, plain, fp8_layers=target.num_layers - target.first_k_dense_replace)
    finally:
        spec_shared.clear()
        gc.collect()
        torch.cuda.empty_cache()


def deepseek_v32_e2e_phase(card: str, shared: dict) -> dict:
    """e2e_deepseek_v32_fp8: DeepSeek-V3.2 at full width, LV3 layers (V3's seeded tree
    plus the indexer), a bf16 cache whose rows carry the indexer's keys (704 wide), the
    traffic of V32_TRAFFIC; each decode step launches fp8_bmm three times (the MoE
    layer's dense combine at 32 rows), flash_prefill and paged_decode never (DSA gathers
    its picks); every prefill step has >= 768 rows, so fp8_bmm does not launch there.
    One run, traced, then the greedy requests on an eager_mode engine."""
    from lmdeploy_tpu_torch.models import build_model
    cfg = v3_config(DEEPSEEK_V32)
    rng = np.random.RandomState(SEED + 13)
    prompts = [rng.randint(3, 32000, size=n).tolist()
               for count, n in V32_TRAFFIC for _ in range(count)]
    e2e_shared = {'init': _with_indexer(_v3_tree(shared), build_model(v3_config(DEEPSEEK_V32)))}
    moe = cfg.num_layers - cfg.first_k_dense_replace
    try:
        return e2e_phase('e2e_deepseek_v32_fp8', cfg, 32, 0, 0, {'fp8_bmm': (0, 3 * moe)},
                         card, long_len=max(n for _, n in V32_TRAFFIC), exact=True,
                         shared=e2e_shared, forbid=('flash_prefill', 'paged_decode'), runs=1,
                         new_tokens=V32_NEW, prompts=prompts, cache_blocks=V32_BLOCKS,
                         graphs_check=dict(traffic=('greedy',), trace=False))
    finally:
        e2e_shared.clear()


def mtp_dsa_phase(card: str) -> dict:
    """The slice's cells: mtp_step, parity_deepseek_v32 (two rows), spec_mtp_deepseek_v3
    and e2e_deepseek_v32_fp8, sharing V3's seeded tree; returns the e2e rows by name."""
    shared = {}
    gc.collect()
    torch.cuda.empty_cache()
    try:
        mtp_step_check(card)
        dsa_parity_phase(card, shared)
        paths = {'spec_mtp_deepseek_v3': spec_mtp_phase(card, shared),
                 'e2e_deepseek_v32_fp8': deepseek_v32_e2e_phase(card, shared)}
    finally:
        shared.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return paths


# Qwen/Qwen3-Next-80B-A3B-Instruct's published config.json (the fields the port reads)
QWEN3_NEXT_80B = {
    'architectures': ['Qwen3NextForCausalLM'], 'model_type': 'qwen3_next',
    'hidden_size': 2048, 'intermediate_size': 5120, 'num_hidden_layers': 48,
    'num_attention_heads': 16, 'num_key_value_heads': 2, 'head_dim': 256,
    'partial_rotary_factor': 0.25, 'rope_theta': 10000000, 'max_position_embeddings': 262144,
    'linear_num_key_heads': 16, 'linear_num_value_heads': 32, 'linear_key_head_dim': 128,
    'linear_value_head_dim': 128, 'linear_conv_kernel_dim': 4, 'full_attention_interval': 4,
    'num_experts': 512, 'num_experts_per_tok': 10, 'moe_intermediate_size': 512,
    'shared_expert_intermediate_size': 512, 'norm_topk_prob': True, 'decoder_sparse_step': 1,
    'mlp_only_layers': [], 'vocab_size': 151936, 'tie_word_embeddings': False,
    'rms_norm_eps': 1e-6, 'torch_dtype': 'bfloat16', 'bos_token_id': 151643,
    'eos_token_id': 151645}
# the cells' depth, cut from 48 layers: one block of 3 gated-DeltaNet layers and 1 gated
# full-attention layer, each with its 512-expert MoE (12.9 GB of bf16 experts); widths,
# experts and vocabulary as published
QN_LAYERS = 4
# parity_qwen3_next: one 4,096-token prompt (the chunked form) beside a 3,000-token one
# padded in the same chunk (the row on which a conv state taken from padded positions
# shows), then 8 teacher-forced decode steps; bf16 with the kernels against the port's
# f32 plain path, both on the card.  The allowance lies above the floor (bf16 through the
# plain versions) and below the mildest planted trap: first reads (H100 80GB HBM3,
# 700 W) floor 0.1475, the kernels 0.1468, the rope over all dims 0.4634 (the other
# traps 4.5-6.6), logits of std 0.905
QN_PARITY_LENS = (4096, 3000)
QN_PARITY_STEPS = 8
QN_LOGIT_TOL = 0.25
# e2e_qwen3_next_80b_a3b's traffic: the MoE cells' (63 x 256 + one 4,096-token prompt),
# 32 greedy tokens each
QN_NEW = 32


def qwen3_next_config(num_layers: int = QN_LAYERS, dtype: str = 'auto', cfg: dict = None):
    """A ModelConfig of Qwen3-Next-80B-A3B (or ``cfg``) at ``num_layers``, the
    registry's fields set (the paged layers: the full-attention ones)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    config = ModelConfig.from_hf_config(
        dict(cfg or QWEN3_NEXT_80B, num_hidden_layers=num_layers), dtype=dtype)
    build_model(config)
    return config


def qwen3_5_moe_widths_config(dtype: str = 'auto'):
    """Qwen3.5-MoE's layout (split projections; text_config nested) at Qwen3-Next-80B-A3B's
    widths and QN_LAYERS layers: no Qwen3.5 config is in the repository."""
    text = {k: v for k, v in QWEN3_NEXT_80B.items() if k not in ('architectures',
                                                                  'model_type')}
    return qwen3_next_config(cfg={'architectures': ['Qwen3_5MoeForConditionalGeneration'],
                                  'model_type': 'qwen3_5_moe', 'torch_dtype': 'bfloat16',
                                  'text_config': dict(text, num_hidden_layers=QN_LAYERS)},
                             dtype=dtype)


def _qn_tree(shared: dict) -> dict:
    """Qwen3-Next-80B-A3B's seeded bf16 tree at QN_LAYERS layers, drawn a matrix at a time
    (14.5 GB; a leaf drawn whole in f32 would take 8.6 GB beside it), made once for the
    parity and e2e cells."""
    from lmdeploy_tpu_torch.models.qwen3_next import Qwen3NextModel
    if 'qn' not in shared:
        shared['qn'] = _seeded_by_matrix(Qwen3NextModel(qwen3_next_config()), SEED + 21)
    return shared['qn']


def _qwen3_5_tree(tree: dict, model) -> dict:
    """The same network in Qwen3.5's layout: each linear layer's per-key-head
    [q | k | v | z] and [b | a] columns regrouped as [q_all | k_all | v_all], z and
    [b_all | a_all] (the other leaves shared)."""
    b = dict(tree['blocks'])
    hk, dk, dv, r = model.lin_hk, model.lin_dk, model.lin_dv, model.ratio
    qkvz = b.pop('lin_in_qkvz')
    lead = qkvz.shape[:-1]
    g = qkvz.reshape(*lead, hk, 2 * dk + 2 * r * dv)
    parts = [g[..., :dk], g[..., dk:2 * dk], g[..., 2 * dk:2 * dk + r * dv],
             g[..., 2 * dk + r * dv:]]
    q, k, v, z = (x.reshape(*lead, -1) for x in parts)
    b['lin_in_qkv'] = torch.cat([q, k, v], -1).contiguous()
    b['lin_in_z'] = z.contiguous()
    ba = b['lin_in_ba'].reshape(*lead, hk, 2 * r)
    b['lin_in_ba'] = torch.cat([ba[..., :r].reshape(*lead, -1),
                                ba[..., r:].reshape(*lead, -1)], -1).contiguous()
    return dict(tree, blocks=b)


class _Routes:
    """Records each MoE call's expert choices (``record``), or forces the recorded ones
    in the same order (``force``: the weights from the run's own router probabilities)
    and counts the tokens whose own choice differs (``flips``)."""

    def __init__(self):
        self.log, self.mode, self.i, self.flips = [], None, 0, 0

    def swaps(self):
        from lmdeploy_tpu_torch.models.qwen3_next import Qwen3NextModel, _f32_dot
        route = Qwen3NextModel.route

        def routed(model, w, j, xf):
            idx, wts = route(model, w, j, xf)
            if self.mode == 'record':
                self.log.append(idx)
            elif self.mode == 'force':
                forced = self.log[self.i].to(idx.device)
                self.i += 1
                self.flips += int((idx.sort(-1).values != forced.sort(-1).values)
                                  .any(-1).sum())
                probs = torch.softmax(_f32_dot(xf, w['router'][j]), dim=-1)
                wts = probs.gather(1, forced)
                if model.norm_topk:
                    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
                idx = forced
            return idx, wts
        return [(Qwen3NextModel, 'route', routed)]


def _qn_run(model, params, ids, lens, steps, tokens=None, rope_all_dims=False):
    """A fresh prefill of the rows ``ids`` [B, T] (``lens`` valid tokens each) into slots
    0..B-1, then ``steps`` decode steps fed ``tokens`` (or the run's own argmax): the
    logits [1 + steps, B, V] f32 at each row's last token, and the tokens fed."""
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    cfg = model.config
    B, T = ids.shape
    BS = 128
    dev = params['embed'].device
    W = -(-(T + steps) // BS)
    dtype = params['embed'].dtype
    cache = {'pages': torch.zeros((cfg.cache_layers, 1 + B * W, 2, BS,
                                   cfg.num_key_value_heads * cfg.head_dim), dtype=dtype,
                                  device=dev)}
    cache.update({n: torch.zeros(shape, dtype=dt, device=dev)
                  for n, (shape, dt) in model.state_shapes(B + 1).items()})
    rdim = cfg.head_dim if rope_all_dims else cfg.rope_dim
    cos, sin = make_rope_table(rdim, W * BS, cfg.rope_theta, device=dev)
    tables = (1 + torch.arange(B * W, dtype=torch.int32, device=dev)).reshape(B, W)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T).contiguous()
    meta = AttnMeta(tables, torch.zeros(B, dtype=torch.int32, device=dev), lens_t,
                    slot_rows=torch.arange(B, device=dev),
                    reset_rows=torch.ones(B, dtype=torch.bool, device=dev))
    out, fed = [], []
    with torch.no_grad():
        out.append(model.forward(params, ids, pos, cache, meta, cos, sin,
                                 fresh_prefill=True).float())
        for i in range(steps):
            tok = (tokens[i] if tokens is not None
                   else out[-1].argmax(-1).int()[:, None])
            fed.append(tok)
            hist = lens_t + i
            step_meta = AttnMeta(tables, hist, torch.ones(B, dtype=torch.int32, device=dev))
            out.append(model.forward(params, tok, hist[:, None].contiguous(), cache, step_meta,
                                     cos, sin).float())
    return torch.stack(out), fed


def _qn_traps():
    """(name, model-dtype tree edit or None, swaps, rope over all dims) of
    parity_qwen3_next's planted traps: the zero-centred norms used without their +1;
    in_proj_qkvz split as contiguous quarters, not per key head; the conv state taken
    from the padded chunk's last K-1 positions, not the last valid inputs; the partial
    rope rotating all 256 dims."""
    from lmdeploy_tpu_torch.models import qwen3_next
    from lmdeploy_tpu_torch.ops.gated_delta import causal_conv1d

    def minus_one(tree):
        b = dict(tree['blocks'])
        for k in ('attn_norms', 'mlp_norms', 'fa_q_norm', 'fa_k_norm'):
            b[k] = b[k] - 1
        return dict(tree, blocks=b, final_norm=tree['final_norm'] - 1)

    def halves(self, w, j, x):
        B, T, _ = x.shape
        kd, vd, hv = self.key_dim, self.value_dim, self.lin_hv
        qkvz = torch.matmul(x, w['lin_in_qkvz'][j])
        q, k, v, z = qkvz.split([kd, kd, vd, vd], dim=-1)
        ba = torch.matmul(x, w['lin_in_ba'][j])
        return (q.reshape(B, T, self.lin_hk, -1), k.reshape(B, T, self.lin_hk, -1),
                v.reshape(B, T, hv, -1), z.reshape(B, T, hv, -1), ba[..., :hv], ba[..., hv:])

    def padded_state(x, conv_state, weight, bias, lens):
        y, _ = causal_conv1d(x, conv_state, weight, bias, lens)
        full = torch.cat([conv_state.to(x.dtype), x], dim=1)
        return y, full[:, -(weight.shape[-1] - 1):].to(conv_state.dtype)
    return [('norms_without_plus_one', minus_one, [], False),
            ('qkvz_split_as_halves', None,
             [(qwen3_next.Qwen3NextModel, '_delta_proj', halves)], False),
            ('conv_state_from_padded_positions', None,
             [(qwen3_next, 'causal_conv1d', padded_state)], False),
            ('rope_over_all_dims', None, [], True)]


def qwen3_next_parity_phase(card: str, shared: dict) -> list:
    """parity_qwen3_next: Qwen3-Next-80B-A3B at full width and QN_LAYERS layers, the
    prefill of QN_PARITY_LENS in one chunk (T 4,096: the chunked form) and
    QN_PARITY_STEPS decode steps, bf16 with the kernels (rows 1-2 at Hq 16 / Hkv 2 /
    D 256) against the f32 plain path on the card (the host is short of memory for
    29 GB of f32 weights); the bf16 runs take the f32 run's expert choices (their own
    counted as flips).  The largest logit difference must lie within QN_LOGIT_TOL, the
    floor (bf16 through the plain versions) below it and every trap of ``_qn_traps``
    above it.  parity_qwen3_5_moe_widths: the same network in Qwen3.5-MoE's split layout
    (``Qwen3_5TextModel``), bf16 with the kernels against the same f32 run, with its
    [b | a] halves swapped as the trap."""
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.models.qwen3_5 import Qwen3_5TextModel
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED + 23)
    T = max(QN_PARITY_LENS)
    ids = torch.from_numpy(rng.randint(3, 150000, size=(len(QN_PARITY_LENS), T))).int().cuda()
    p16 = _qn_tree(shared)
    m16, m32 = build_model(qwen3_next_config()), build_model(qwen3_next_config(dtype='float32'))
    routes = _Routes()
    p32 = _to(p16, torch.float32)
    routes.mode = 'record'
    with _plain_kernels(), _swapped(*routes.swaps()):
        ref, fed = _qn_run(m32, p32, ids, QN_PARITY_LENS, QN_PARITY_STEPS)
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    def read(model, params, swaps=(), plain=False, rope_all_dims=False):
        routes.mode, routes.i, routes.flips = 'force', 0, 0
        with (_plain_kernels() if plain else contextlib.nullcontext()), \
                _swapped(*routes.swaps(), *swaps):
            out, _ = _qn_run(model, params, ids, QN_PARITY_LENS, QN_PARITY_STEPS, fed,
                             rope_all_dims)
        return (out - ref).abs().max().item(), routes.flips

    err, flips = read(m16, p16)
    floor, _ = read(m16, p16, plain=True)
    traps = {}
    for trap, edit, swaps, rope_all in _qn_traps():
        model = m16
        if rope_all:
            model = build_model(dataclasses.replace(qwen3_next_config(),
                                                    partial_rotary_factor=1.0))
        traps[trap] = read(model, edit(p16) if edit else p16, swaps, rope_all_dims=rope_all)[0]
    row = {'phase': 'parity_qwen3_next', 'card': card,
           'model': f'qwen3-next-80b-a3b geometry, {QN_LAYERS} layers (3 gated-DeltaNet, 1 '
                    f'gated full attention), 512 experts top-10, random seeded bf16 weights',
           'prompt_tokens': list(QN_PARITY_LENS), 'decode_steps': QN_PARITY_STEPS,
           'max_abs_logit_err': err, 'floor': floor, 'logit_tol': QN_LOGIT_TOL,
           'logit_std': ref.std().item(), 'routing_flips_own_choices': flips,
           'traps': traps}
    row['ok'] = floor < QN_LOGIT_TOL and err <= QN_LOGIT_TOL and all(
        t > QN_LOGIT_TOL for t in traps.values())
    emit(row)
    rows = [row]
    # the same network in Qwen3.5-MoE's layout, against the same f32 run
    c35 = qwen3_5_moe_widths_config()
    m35 = build_model(c35)
    assert isinstance(m35, Qwen3_5TextModel)
    p35 = _qwen3_5_tree(p16, m35)

    def ba_swapped(tree):
        b = dict(tree['blocks'])
        hv = m35.lin_hv
        b['lin_in_ba'] = torch.cat([b['lin_in_ba'][..., hv:], b['lin_in_ba'][..., :hv]], -1)
        return dict(tree, blocks=b)
    err35, flips35 = read(m35, p35)
    trap35 = read(m35, ba_swapped(p35))[0]
    row35 = {'phase': 'parity_qwen3_5_moe_widths', 'card': card,
             'model': f'Qwen3_5MoeForConditionalGeneration layout (split in_proj_qkv / z / b '
                      f'/ a) at qwen3-next-80b-a3b widths, {QN_LAYERS} layers, the same '
                      f'seeded network',
             'max_abs_logit_err': err35, 'logit_tol': QN_LOGIT_TOL,
             'routing_flips_own_choices': flips35, 'traps': {'b_and_a_swapped': trap35}}
    row35['ok'] = err35 <= QN_LOGIT_TOL and trap35 > QN_LOGIT_TOL
    emit(row35)
    rows.append(row35)
    del p35, ref
    gc.collect()
    torch.cuda.empty_cache()
    for r in rows:
        if not r['ok']:
            raise SystemExit(f'{r["phase"]} failed: {r}')
    return rows


def _hybrid_state_check(card: str):
    """On the e2e cell's engine after its runs: every live slot's conv and rec state
    (overwritten with random values) is left bit for bit as it was by a graph runner's
    scratch pass and by a replay of a captured decode run whose rows are all inactive;
    then, traced, an eager fresh prefill step of the cell's long prompt (1 x 4,096
    tokens) and 8 eager decode steps at the cell's decode shape (64 rows, 63 at 256 +
    QN_NEW / 2 kv tokens and one at 4,096 + QN_NEW / 2, each on pages of its own): the
    gated-delta ops' share of device time (conv, gates and recurrence under one
    ``record_function`` range)."""
    def check(engine) -> dict:
        from torch.profiler import ProfilerActivity, profile, record_function
        from lmdeploy_tpu_torch.models import qwen3_next
        from lmdeploy_tpu_torch.models.llama import AttnMeta
        agent = engine.model_agent
        cache = agent.kv_cache
        gen = torch.Generator(device='cuda').manual_seed(SEED + 29)
        live = slice(0, agent.max_batch)
        with agent._on_stream():
            for k in ('conv', 'rec'):
                cache[k].copy_(torch.randn(cache[k].shape, generator=gen, device='cuda'))
            agent.decode_state.active.zero_()
            before = {k: cache[k][:, live].clone() for k in ('conv', 'rec')}
            run = next(r for r in agent.graphs.runs.values() if r.graph is not None)
            agent._decode_body(run, scratch=True)
            agent.stream.synchronize()
            scratch_ok = all(torch.equal(cache[k][:, live], before[k]) for k in before)
            run.graph.replay()
            agent.stream.synchronize()
            replay_ok = all(torch.equal(cache[k][:, live], before[k]) for k in before)

        def ranged(fn):
            def inner(*args, **kwargs):
                with record_function('gated_delta'):
                    return fn(*args, **kwargs)
            return inner
        swaps = [(qwen3_next, n, ranged(getattr(qwen3_next, n)))
                 for n in ('causal_conv1d', 'gate_decay', 'gated_delta_scan')]
        bs, num_blocks = cache['pages'].shape[3], cache['pages'].shape[1]
        mid = QN_NEW // 2
        shares = {}
        for label, T, hist, steps in (('prefill_1x4096', 4096, [0], 1),
                                      ('decode_64_rows', 1, [256 + mid] * 63 + [4096 + mid], 8)):
            B = len(hist)
            need = [-(-(h + T) // bs) for h in hist]
            assert sum(need) < num_blocks, (need, num_blocks)
            starts = np.cumsum([1] + need[:-1])
            tables = torch.zeros((B, max(need)), dtype=torch.int32)
            for r, (s0, n) in enumerate(zip(starts, need)):
                tables[r, :n] = torch.arange(s0, s0 + n, dtype=torch.int32)
            hist_t = torch.tensor(hist, dtype=torch.int32, device='cuda')
            ids = torch.randint(3, 150000, (B, T), generator=gen, device='cuda').int()
            pos = (hist_t[:, None] + torch.arange(T, dtype=torch.int32, device='cuda')
                   ).contiguous()
            meta = AttnMeta(tables.cuda(), hist_t,
                            torch.full((B,), T, dtype=torch.int32, device='cuda'),
                            slot_rows=torch.arange(B, device='cuda'),
                            reset_rows=torch.full((B,), T > 1, device='cuda'))
            torch.cuda.synchronize()
            with _swapped(*swaps), profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    agent.model.forward(agent.params, ids, pos, cache, meta,
                                        agent.rope_cos, agent.rope_sin, fresh_prefill=T > 1)
                torch.cuda.synchronize()
            shares[label] = dict(_ranged_device_share(prof, 'gated_delta'),
                                 mean_kv_tokens=float(np.mean(hist)) + T)
        row = {'phase': 'hybrid_state_check', 'of': 'e2e_qwen3_next_80b_a3b', 'card': card,
               'scratch_pass_state_bit_equal': scratch_ok,
               'inactive_replay_state_bit_equal': replay_ok,
               'gated_delta_share_of_device_time': shares}
        row['ok'] = scratch_ok and replay_ok
        emit(row)
        return row
    return check


def _ranged_device_share(prof, label: str) -> dict:
    """From a trace of CPU and CUDA activity: the device time of the kernels (and
    copies) launched inside the ``record_function(label)`` ranges, matched by the
    correlation id of each one's launch call, and its share of all device time."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    ranges = [(e.start_ns(), e.end_ns()) for e in events
              if e.device_type() != DeviceType.CUDA and e.name() == label]
    launched_in = {e.correlation_id() for e in events
                   if e.device_type() != DeviceType.CUDA and e.correlation_id()
                   and any(lo <= e.start_ns() <= hi for lo, hi in ranges)}
    device = [e for e in events if e.device_type() == DeviceType.CUDA and e.name() != label]
    total = sum(e.duration_ns() for e in device)
    inside = sum(e.duration_ns() for e in device if e.correlation_id() in launched_in)
    return {'ranges': len(ranges), f'{label}_device_ms': inside / 1e6,
            'device_ms': total / 1e6, 'share': inside / total if total else None}


def qwen3_next_phase(card: str) -> dict:
    """The slice's cells: parity_qwen3_next (two rows) and e2e_qwen3_next_80b_a3b
    (QN_LAYERS layers, the MoE cells' traffic: 63 x 256 + one 4,096-token prompt, 32
    greedy tokens; one flash_prefill a fresh prefill step and one paged_decode a decode
    step, exactly; the state check of ``_hybrid_state_check``; traced; then the greedy
    requests on an eager_mode engine, tokens equal), sharing one seeded tree; returns the
    e2e row by name."""
    shared = {}
    gc.collect()
    torch.cuda.empty_cache()
    try:
        qwen3_next_parity_phase(card, shared)
        cfg = qwen3_next_config()
        e2e_shared = {'init': _qn_tree(shared)}
        full = cfg.cache_layers
        row = e2e_phase('e2e_qwen3_next_80b_a3b', cfg, 64, 0, 63,
                        {'flash_prefill': (full, 0), 'paged_decode': (0, full)}, card,
                        short_len=256, long_len=4096, exact=True, shared=e2e_shared, runs=1,
                        new_tokens=QN_NEW,
                        graphs_check=dict(traffic=('greedy',), trace=False),
                        engine_check=_hybrid_state_check(card))
        e2e_shared.clear()
    finally:
        shared.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return {'e2e_qwen3_next_80b_a3b': row}


# -- guided decoding, bad words and S-LoRA on Llama-3.1-8B -------------------------
# one batch of 64 rows, 32 new tokens each, 128-token prompts
GUIDED_NEW = 32
GUIDED_PROMPT = 128
GUIDED_SCHEMA = {'type': 'object',
                 'properties': {'name': {'type': 'string'}, 'age': {'type': 'integer'},
                                'color': {'enum': ['red', 'green', 'blue']},
                                'scores': {'type': 'array', 'items': {'type': 'number'}}},
                 'required': ['name', 'age', 'color', 'scores']}
GUIDED_FORMATS = {'json_object': {'type': 'json_object'},
                  'json_schema': {'type': 'json_schema',
                                  'json_schema': {'name': 'record', 'schema': GUIDED_SCHEMA}},
                  'regex_schema': {'type': 'regex_schema',
                                   'regex_schema': r'\d{4}-\d{2}-\d{2}'}}
# rows: 8 greedy rows of each format, 8 sampled json_object rows (top-k 40, seeded), 8
# bad-words rows (16 banned ids each: the first distinct tokens their prompts' plain
# twins, rows 40-47, emit), 24 plain rows
GUIDED_ROWS = ([('greedy', f) for f in GUIDED_FORMATS for _ in range(8)]
               + [('sampled', 'json_object')] * 8 + [('bad', None)] * 8 + [('plain', None)] * 24)
BAD_WORDS = 16
# a greedy guided row's tokens on the graph runs with grammar acceptance may leave its
# per-step masked tokens only where the masked top-2 margin lies below this: the two
# paths run the rows in other batch buckets (a host step's eager B against a run's), as
# the speculative verify does against the decode (VERIFY_MARGIN_TOL)
GUIDED_MARGIN_TOL = 0.3
# S-LoRA: two seeded adapters on all seven targets, ranks 8 and 16, alpha 2r; a mixed
# batch of 64 rows (none, a, b in turn)
SLORA_RANKS = {'a': 8, 'b': 16}
SLORA_STD = 0.03
# bf16 S-LoRA logits (the card's engine leaves, the stacks in f32) against f32 on the
# merged weights, 2 full-width layers: LOGIT_TOL_CP's allowance for Llama-3.1-8B at 2
# layers (first card read beside it in PERF.md)
SLORA_LOGIT_TOL = 0.2
# the engines' own top-2 logprobs (decode graph replays) against the f32 log-softmax
# of the weights their rows were served with, fed the same tokens: the same allowance
SLORA_LP_TOL = 0.2
SLORA_LOGIT_ROWS = 12
SLORA_LOGIT_STEPS = 4
SLORA_BLOCKS = 512


class SeededVocab:
    """A tokenizer stand-in: ``V`` seeded strings, ``decode(ids)`` their concatenation.
    The first pieces are JSON's punctuation, digits, number characters, whitespace, the
    literals and their prefixes and some multi-character JSON pieces; the rest up to
    ``special_from`` are 1-6 characters drawn mostly from letters (digits, spaces and
    punctuation among them); the ids from ``special_from`` (Llama-3's 256 special
    tokens) decode to nothing, so no mask allows them but EOS."""

    def __init__(self, V: int, special_from: int, seed: int):
        rng = np.random.RandomState(seed)
        fixed = (list('{}[]:,"') + list('0123456789') + list('-.+eE') + [' ', '\n', '\t', '\\']
                 + ['true', 'false', 'null', 'tr', 'fal', 'nu', 'ul', 'se', 'ue']
                 + ['": ', '", "', '{"', '"}', '["', '"]', '],', '},', ', ', ': ', ' "',
                    '2024', '-1', '0.5', '12', 'red', 'green', 'blue', 'name', 'age'])
        letters = [chr(c) for c in range(97, 123)] + [chr(c) for c in range(65, 91)]
        alphabet = np.array(letters * 6 + list('0123456789') * 2 + list(' _-.,:"{}[]!?/'))
        n = special_from - len(fixed)
        lengths = rng.randint(1, 7, size=n)
        flat = ''.join(rng.choice(alphabet, size=int(lengths.sum())))
        ends = np.cumsum(lengths)
        self.pieces = fixed + [flat[e - ln:e] for e, ln in zip(ends.tolist(), lengths.tolist())]
        self.pieces += [''] * (V - len(self.pieces))

    def decode(self, ids, **kwargs) -> str:
        return ''.join(self.pieces[i] for i in ids)


def fresh_guide(vocab, fmt: dict, eos):
    """A guide of ``fmt`` at its start state (as ``Engine._make_guide`` builds it)."""
    from lmdeploy_tpu_torch.guided import JsonGuide
    from lmdeploy_tpu_torch.guided_regex import RegexGuide
    from lmdeploy_tpu_torch.guided_schema import SchemaGuide
    V = len(vocab.pieces)
    if fmt['type'] == 'json_object':
        return JsonGuide(vocab, V, eos)
    if fmt['type'] == 'json_schema':
        return SchemaGuide(vocab, V, eos, fmt['json_schema']['schema'])
    return RegexGuide(vocab, V, eos, fmt['regex_schema'])


def grammar_ok(vocab, fmt: dict, eos, ids, new_tokens: int) -> bool:
    """A fresh guide accepts every token of ``ids``, and a row that stopped early (on
    EOS, which the engine strips) ends in a complete state."""
    from lmdeploy_tpu_torch.guided import JsonGuide, is_complete
    g = fresh_guide(vocab, fmt, eos)
    if not all(g.accept_token(int(t)) for t in ids):
        return False
    done = is_complete(g.state) if isinstance(g, JsonGuide) else g._is_complete()
    return len(ids) == new_tokens or done


class MaskMeter:
    """Times ``allowed_mask`` of the three guide classes inside the block: calls, the
    distinct masks computed (the class's mask cache grew: a scan of the vocabulary) and
    their seconds, the cache hits."""

    def __init__(self):
        from lmdeploy_tpu_torch.guided import JsonGuide
        from lmdeploy_tpu_torch.guided_regex import RegexGuide
        from lmdeploy_tpu_torch.guided_schema import SchemaGuide
        self.classes = (JsonGuide, SchemaGuide, RegexGuide)
        self.stats = {c.__name__: {'calls': 0, 'distinct': 0, 'distinct_s': 0.0}
                      for c in self.classes}

    def _timed(self, cls):
        orig, st = cls.allowed_mask, self.stats[cls.__name__]

        def allowed_mask(guide):
            n = len(cls._mask_cache)
            t0 = time.perf_counter()
            out = orig(guide)
            st['calls'] += 1
            if len(cls._mask_cache) > n:
                st['distinct'] += 1
                st['distinct_s'] += time.perf_counter() - t0
            return out
        return allowed_mask

    def swapped(self):
        return _swapped(*[(c, 'allowed_mask', self._timed(c)) for c in self.classes])

    def row(self) -> dict:
        out = {}
        for name, st in self.stats.items():
            out[name] = {'calls': st['calls'], 'distinct_masks': st['distinct'],
                         'cache_hits': st['calls'] - st['distinct'],
                         'ms_per_distinct_mask': (1e3 * st['distinct_s'] / st['distinct']
                                                  if st['distinct'] else None)}
        return out


class GuidedCounters:
    """On one engine: host steps and their rows, guided rows recovering from a
    rejection and rows demoted by their acceptance EMA at a host step, the rejections
    found by the drain, each guided row's last acceptance EMA, and plain rows that took
    a host step (there must be none)."""

    def __init__(self, engine):
        self.engine = engine
        self.host, self.drain = engine._decode_step_host, engine._drain_decode_tokens
        engine._decode_step_host, engine._drain_decode_tokens = self._host, self._drain
        self.reset()

    def reset(self):
        self.host_steps = self.host_rows = self.recoveries = self.demoted = 0
        self.rejections = self.plain_host_rows = 0
        self.ema = {}

    async def _host(self, seqs, loop):
        from lmdeploy_tpu_torch.paging.seq import MessageStatus
        seqs = [s for s in seqs if s.status == MessageStatus.RUNNING]
        if seqs:
            self.host_steps += 1
            self.host_rows += len(seqs)
        for s in seqs:
            if s.guided is None and not s.sampling_params.bad_token_ids:
                self.plain_host_rows += 1
            elif getattr(s, '_guided_recover', False):
                self.recoveries += 1
            elif s.guided is not None and getattr(s, '_guided_ema', 1e9) < 2.0:
                self.demoted += 1
        return await self.host(seqs, loop)

    def _drain(self, seq, toks, lps, tops=None):
        flagged = getattr(seq, '_guided_recover', False)
        out = self.drain(seq, toks, lps, tops)
        if seq.guided is not None:
            self.rejections += getattr(seq, '_guided_recover', False) and not flagged
            if hasattr(seq, '_guided_ema'):
                self.ema[seq.seq_id] = seq._guided_ema
        return out

    def row(self) -> dict:
        return {'host_steps': self.host_steps, 'host_rows': self.host_rows,
                'recovery_steps': self.recoveries, 'rejections': self.rejections,
                'ema_demoted_rows': self.demoted, 'plain_host_rows': self.plain_host_rows,
                'acceptance_ema_mean': (statistics.mean(self.ema.values())
                                        if self.ema else None),
                'rows_with_ema': len(self.ema)}


def serve_rows(engine, prompts, kws):
    """Serve ``prompts`` at once, each with its GenerationConfig keywords ``kws``:
    (outputs, t0, t1)."""
    from lmdeploy_tpu_torch.messages import GenerationConfig
    inst = engine.create_instance()

    async def go():
        return await asyncio.gather(*[inst.async_infer(i + 1, p, GenerationConfig(**kw))
                                      for i, (p, kw) in enumerate(zip(prompts, kws))])
    t0 = time.time()
    outs = asyncio.run(go())
    torch.cuda.synchronize()
    return outs, t0, time.time()


def margin_differences(tokens, ref_outs, rows, tol: float) -> tuple:
    """For each of ``rows`` whose ``tokens`` leave ``ref_outs``' tokens: the first
    differing position and the reference run's top-2 logprob margin there (its masked
    logits' for a guided row).  Returns (the differences, all within ``tol``)."""
    diffs = []
    for i in rows:
        a, b = list(tokens[i]), list(ref_outs[i].token_ids)
        j = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 None if len(a) == len(b) else min(len(a), len(b)))
        if j is None:
            continue
        margins = _top2_margins(ref_outs[i])
        diffs.append({'row': i, 'position': j,
                      'margin': margins[j] if j < len(margins) else None})
    return diffs, all(d['margin'] is not None and d['margin'] < tol for d in diffs)


def _counted_run(engine, prompts, kws):
    """One run with every kernel counter and graph count set to 0 before: (outputs,
    t0, t1, launches, combines, graph stats, steps), the steps counting the prefill
    steps (``fresh_prefill``: every chunk starts its prompt), the decode runs
    dispatched and their decode steps, and the single host decode steps."""
    agent = engine.model_agent
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, 'combines'):
            fn.combines = 0
    agent.graphs.reset_counts()
    steps = {'prefill': 0, 'fresh_prefill': 0, 'decode_runs': 0, 'run_steps': 0,
             'host_steps': 0}
    prefill, decode, decode_run = agent.prefill, agent.decode, agent.decode_run

    def counted_prefill(chunks):
        steps['prefill'] += 1
        steps['fresh_prefill'] += all(c.start == 0 for c in chunks)
        return prefill(chunks)

    def counted_decode(seqs):
        steps['host_steps'] += 1
        return decode(seqs)

    def counted_run(num_rows, k=None, *args, **kwargs):
        steps['decode_runs'] += 1
        steps['run_steps'] += k or agent.decode_run_steps
        return decode_run(num_rows, k, *args, **kwargs)
    agent.prefill, agent.decode, agent.decode_run = counted_prefill, counted_decode, counted_run
    try:
        outs, t0, t1 = serve_rows(engine, prompts, kws)
    finally:
        agent.prefill, agent.decode, agent.decode_run = prefill, decode, decode_run
    launches, combines = agent.graphs.launch_totals()
    return (outs, t0, t1, {n: launches[fn.__name__] for n, fn in counters.items()},
            {n: combines[fn.__name__] for n, fn in counters.items() if hasattr(fn, 'combines')},
            agent.graphs.stats(), steps)


def slora_adapters(cfg, seed: int) -> dict:
    """Two seeded adapters on all seven targets of every layer of the model ``cfg``,
    ranks SLORA_RANKS and alpha 2r, as their PEFT tensors in memory (the card has no
    safetensors), parsed by ``lora.peft_weights``: name -> (weights, scaling)."""
    from lmdeploy_tpu_torch.lora import peft_weights
    H, I = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    dims = {'self_attn.q_proj': (H, q), 'self_attn.k_proj': (H, kv),
            'self_attn.v_proj': (H, kv), 'self_attn.o_proj': (q, H),
            'mlp.gate_proj': (H, I), 'mlp.up_proj': (H, I), 'mlp.down_proj': (I, H)}
    rng = np.random.RandomState(seed)
    out = {}
    for name, r in SLORA_RANKS.items():
        tensors = {}
        for layer in range(cfg.num_layers):
            for mod, (k, n) in dims.items():
                p = f'base_model.model.model.layers.{layer}.{mod}.'
                for ab, shape in (('A', (r, k)), ('B', (n, r))):
                    tensors[p + f'lora_{ab}.weight'] = (
                        rng.standard_normal(shape) * SLORA_STD).astype(np.float32)
        out[name] = peft_weights(tensors, {'r': r, 'lora_alpha': 2 * r})
    return out


def _lora_logits(model, params, ids, steps: int, adapter_ids=None, tokens=None):
    """A fresh prefill of the rows ``ids`` [B, T] into pages of their own, then
    ``steps`` decode steps fed ``tokens`` (or the run's own argmax), through the model's
    forward (S-LoRA rows by ``adapter_ids``): the logits [1 + steps, B, V] f32 and the
    tokens fed."""
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    cfg = model.config
    B, T = ids.shape
    BS = 128
    dev = params['embed'].device
    W = -(-(T + steps) // BS)
    cache = torch.zeros((cfg.num_layers, 1 + B * W, 2, BS,
                         cfg.num_key_value_heads * cfg.head_dim),
                        dtype=params['embed'].dtype, device=dev)
    cos, sin = make_rope_table(cfg.rope_dim, W * BS, cfg.rope_theta, cfg.rope_scaling,
                               device=dev)
    tables = (1 + torch.arange(B * W, dtype=torch.int32, device=dev)).reshape(B, W)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T).contiguous()
    kw = {} if adapter_ids is None else {'adapter_ids': adapter_ids}
    out, fed = [], []
    with torch.no_grad():
        out.append(model.forward(params, ids, pos, cache,
                                 AttnMeta(tables, torch.zeros_like(lens), lens), cos, sin,
                                 fresh_prefill=True, **kw).float())
        for i in range(steps):
            tok = tokens[i] if tokens is not None else out[-1].argmax(-1).int()[:, None]
            fed.append(tok)
            hist = lens + i
            out.append(model.forward(params, tok, hist[:, None].contiguous(), cache,
                                     AttnMeta(tables, hist, torch.ones_like(lens)), cos, sin,
                                     **kw).float())
    return torch.stack(out), fed


def _f32_trees(served: dict, adapters: dict):
    """(name, tree) for None (the served leaves widened to f32) and then each adapter
    (those plus ``scaling * A^T B^T`` a layer, computed here on the card in f32 with
    TF32 off, apart from the port's ``lora`` module: its merged weights), one at a
    time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    base32 = {k: ({k2: v2.float() for k2, v2 in v.items()} if isinstance(v, dict)
                  else v.float()) for k, v in served.items() if k != 'lora'}
    yield None, base32
    for name, (weights, scaling) in adapters.items():
        layers = dict(base32['layers'])
        for module, per_layer in weights.items():
            w = layers[module].clone()
            for layer, ab in per_layer.items():
                a, b = (torch.from_numpy(ab[k]).to(w.device) for k in 'AB')
                w[layer] += scaling * (a.T @ b.T)       # [in, r] @ [r, out]
            layers[module] = w
        yield name, dict(base32, layers=layers)
        del layers
        gc.collect()
        torch.cuda.empty_cache()


def engine_logprob_gap(m32, tree, prompts, outs, rows) -> float:
    """The largest gap between an engine's reported logprobs (every id of every
    token of the requests ``rows``) and the f32 log-softmax of ``tree``, prefilled
    with the same prompts and fed the engine's own tokens."""
    dev = tree['embed'].device
    ids = torch.tensor([prompts[i] for i in rows], dtype=torch.int32, device=dev)
    toks = torch.tensor([list(outs[i].token_ids) for i in rows], dtype=torch.int32,
                        device=dev)
    n = toks.shape[1]
    logits, _ = _lora_logits(m32, tree, ids, n - 1,
                             tokens=[toks[:, j:j + 1] for j in range(n - 1)])
    lp = torch.log_softmax(logits, dim=-1)                  # [n, rows, V]
    del logits
    at = [(j, b, t, e[t].logprob) for b, i in enumerate(rows)
          for j, e in enumerate(outs[i].logprobs) for t in e]
    pos, row, tok, val = (list(c) for c in zip(*at))
    got = lp[torch.tensor(pos), torch.tensor(row), torch.tensor(tok)]
    return float((got - torch.tensor(val, device=dev)).abs().max())


def slora_f32_checks(model, served: dict, slot_map: dict, adapters: dict, prompts,
                     plans: dict) -> dict:
    """The S-LoRA engine's model and leaves (bf16, unfused) and stacks ``served``
    against f32 on the merged weights of each adapter (``_f32_trees``).

    Logits: SLORA_LOGIT_ROWS rows (none, a, b in turn), prefill and SLORA_LOGIT_STEPS
    decode steps through the model's forward on ``served``; each row's decode-step
    logits against an f32 run of its tree fed the same tokens, within SLORA_LOGIT_TOL,
    the adapter rows' against the f32 base (``adapter_left_out``) past it.

    Engine logprobs: ``plans`` maps each tree's name to (label, the engine's outputs,
    their rows, sound) entries; each ``engine_logprob_gap`` must lie within
    SLORA_LP_TOL where sound, and past it where not (a trap: the rows served by
    another model than the tree's)."""
    from lmdeploy_tpu_torch.models import build_model
    m32 = build_model(dataclasses.replace(model.config, dtype='float32'))
    dev = served['embed'].device
    names = [None, 'a', 'b']
    rows = [names[i % 3] for i in range(SLORA_LOGIT_ROWS)]
    ids = torch.tensor([prompts[i] for i in range(SLORA_LOGIT_ROWS)], dtype=torch.int32,
                       device=dev)
    slots = torch.tensor([0 if n is None else slot_map[n] for n in rows],
                         dtype=torch.int32, device=dev)
    bf16, fed = _lora_logits(model, served, ids, SLORA_LOGIT_STEPS, adapter_ids=slots)
    out = {'logits': {'tolerance': SLORA_LOGIT_TOL, 'rows': SLORA_LOGIT_ROWS,
                      'decode_steps': SLORA_LOGIT_STEPS},
           'engine_logprobs': {'tolerance': SLORA_LP_TOL, 'sound': {}, 'traps': {}}}
    lg, gaps = out['logits'], out['engine_logprobs']
    base_logits = {}
    for name, tree in _f32_trees(served, adapters):
        key = 'none' if name is None else name
        sel = [i for i, n in enumerate(rows) if n == name]
        idx = torch.tensor(sel, device=dev)
        f32, _ = _lora_logits(m32, tree, ids, SLORA_LOGIT_STEPS, tokens=fed)
        if name is None:
            base_logits = f32[1:]
        card = bf16[1:, idx]
        lg[f'max_abs_err_{key}'] = float((card - f32[1:, idx]).abs().max())
        lg[f'logit_std_{key}'] = float(f32[1:, idx].std())
        if name is not None:
            lg[f'adapter_left_out_{key}'] = float((card - base_logits[:, idx]).abs().max())
        del f32
        for label, outs, plan_rows, sound in plans[name]:
            gap = engine_logprob_gap(m32, tree, prompts, outs, plan_rows)
            (gaps['sound'] if sound else gaps['traps'])[f'{label}_vs_f32_{key}'] = gap
    lg['ok'] = (all(lg[f'max_abs_err_{k}'] <= SLORA_LOGIT_TOL for k in ('none', 'a', 'b'))
                and all(lg[f'adapter_left_out_{k}'] > SLORA_LOGIT_TOL for k in ('a', 'b')))
    gaps['ok'] = (all(g <= SLORA_LP_TOL for g in gaps['sound'].values())
                  and all(g > SLORA_LP_TOL for g in gaps['traps'].values()))
    out['ok'] = lg['ok'] and gaps['ok']
    del bf16, base_logits
    return out


def guided_slora_phase(card: str, shared: dict) -> dict:
    """e2e_llama31_8b_guided_slora: Llama-3.1-8B at full width and L31 layers (the
    seeded bf16 weights ``shared`` with the other Llama-3.1-8B cells), bf16 KV, block
    size 128, 64 rows, decode graphs on, a SeededVocab of the full vocabulary.

    Guided decoding and bad words (engine G): GUIDED_ROWS in one batch, twice: with the
    speculative grammar acceptance (graph runs, rejections, recovery steps) and with
    LMDEPLOY_TPU_GUIDED_SPEC=0 (per-step masked host steps); every guided output is
    legal, the greedy guided rows' tokens agree between the runs (or differ first where
    the masked top-2 margin < GUIDED_MARGIN_TOL), no banned id appears, and no plain row
    takes a host step while every decode run replays its graph; the first run launches
    flash_prefill and paged_decode exactly once a layer of each of its fresh prefill
    and decode steps.  S-LoRA (engine S, the adapters of ``slora_adapters``, its KV
    cache sized from free memory at the default fraction): a batch mixing rows of no
    adapter and of 'a' and 'b'; the no-adapter rows against engine B (the same unfused
    leaves, no adapters), the adapter rows against engine B after ``activate_lora`` (the
    merged weights, replayed by the graphs captured before the merge), and B again
    after ``deactivate_lora`` against its base tokens (up to the unmerge's rounding),
    each under the margin rule; and ``slora_f32_checks``: the forward's logits and each
    engine's own logprobs against f32 on the merged weights, with traps.  Returns the
    phase's row, whose launches are the first guided run's."""
    from lmdeploy_tpu_torch.guided import JsonGuide
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    model = llama31_config(L31)
    V = model.vocab_size
    eos = list(model.eos_token_id)
    t0 = time.perf_counter()
    vocab = SeededVocab(V, model.bos_token_id, SEED + 20)
    vocab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    JsonGuide._token_strings(vocab, V)
    strings_ms = 1e3 * (time.perf_counter() - t0)
    rng = np.random.RandomState(SEED + 21)
    prompts = [rng.randint(3, 32000, size=GUIDED_PROMPT).tolist() for _ in GUIDED_ROWS]
    plain0 = GUIDED_ROWS.index(('plain', None))
    bad0 = GUIDED_ROWS.index(('bad', None))
    for j in range(8):
        prompts[bad0 + j] = prompts[plain0 + j]      # each bad-words row's plain twin
    row = {'phase': 'e2e_llama31_8b_guided_slora', 'model': model_label(model),
           'card': card, 'requests': len(prompts), 'new_tokens': GUIDED_NEW,
           'vocab_build_s': vocab_s, 'token_strings_ms': strings_ms}
    seconds = {}

    def new_engine(env=None, num_blocks=SLORA_BLOCKS, **kw):
        engine, _ = _built(model, 64, 0, GUIDED_PROMPT, 1, shared, env,
                           num_blocks=num_blocks, **kw)
        _warmed(engine, 64)
        return engine

    # -- guided decoding and bad words ---------------------------------------------
    t_g = time.perf_counter()
    engine = new_engine(tokenizer=vocab)
    warm = engine.model_agent.graphs.stats()
    twins, _, _ = serve_rows(engine, prompts[plain0:plain0 + 8],
                             [dict(max_new_tokens=GUIDED_NEW, ignore_eos=True)] * 8)
    banned = []
    for o in twins:
        ids = list(dict.fromkeys(o.token_ids))[:BAD_WORDS]
        while len(ids) < BAD_WORDS:
            t = int(rng.randint(3, 128000))
            ids += [] if t in ids else [t]
        banned.append(ids)

    def kws(per_step: bool):
        out = []
        for i, (kind, fmt) in enumerate(GUIDED_ROWS):
            kw = dict(max_new_tokens=GUIDED_NEW, ignore_eos=kind in ('bad', 'plain'))
            if fmt is not None:
                kw['response_format'] = GUIDED_FORMATS[fmt]
            if kind == 'sampled':
                kw.update(do_sample=True, top_k=40, top_p=1.0, temperature=1.0,
                          random_seed=3000 + i)
            if kind == 'bad':
                kw['bad_token_ids'] = banned[i - bad0]
            if kind == 'greedy' and per_step:
                kw['logprobs'] = 2          # the masked top-2 at each token
            out.append(kw)
        return out
    counters = GuidedCounters(engine)
    meter = MaskMeter()
    with meter.swapped():
        outs, t0, t1, launches, combines, graphs, steps = _counted_run(engine, prompts,
                                                                       kws(False))
        first = counters.row()
        counters.reset()
        saved = os.environ.get('LMDEPLOY_TPU_GUIDED_SPEC')
        os.environ['LMDEPLOY_TPU_GUIDED_SPEC'] = '0'
        try:
            ref, _, _ = serve_rows(engine, prompts, kws(True))
        finally:
            if saved is None:
                os.environ.pop('LMDEPLOY_TPU_GUIDED_SPEC')
            else:
                os.environ['LMDEPLOY_TPU_GUIDED_SPEC'] = saved
        second = counters.row()
    tokens = [o.token_ids for o in outs]
    greedy = [i for i, (k, _) in enumerate(GUIDED_ROWS) if k == 'greedy']
    guided = [i for i, (_, f) in enumerate(GUIDED_ROWS) if f is not None]
    legal = {i: grammar_ok(vocab, GUIDED_FORMATS[GUIDED_ROWS[i][1]], eos, tokens[i],
                           GUIDED_NEW) and
             grammar_ok(vocab, GUIDED_FORMATS[GUIDED_ROWS[i][1]], eos, ref[i].token_ids,
                        GUIDED_NEW) for i in guided}
    diffs, within = margin_differences(tokens, ref, greedy, GUIDED_MARGIN_TOL)
    bad_rows = range(bad0, bad0 + 8)
    no_banned = all(not set(tokens[i]) & set(banned[i - bad0]) and
                    not set(ref[i].token_ids) & set(banned[i - bad0]) for i in bad_rows)
    plain_rows = [i for i, (k, _) in enumerate(GUIDED_ROWS) if k in ('bad', 'plain')]
    lengths_ok = all(len(tokens[i]) == GUIDED_NEW for i in plain_rows)
    replayed = graphs['eager_runs'] == 0 and graphs['replays'] == steps['decode_runs'] > 0
    # one flash_prefill a layer of each fresh prefill step, one paged_decode a layer of
    # each decode step, replayed or a host step's
    need = {'flash_prefill': L31 * steps['fresh_prefill'],
            'paged_decode': L31 * (steps['run_steps'] + steps['host_steps'])}
    launches_ok = (all(launches[n] == need[n] > 0 for n in need)
                   and steps['prefill'] == steps['fresh_prefill'])
    row.update({
        'guided': {'runs': {'grammar_acceptance': first, 'per_step': second},
                   'graph_replays': graphs['replays'], 'steps': steps,
                   'eager_decode_runs': graphs['eager_runs'], 'warmup': warm,
                   'masks': meter.row(),
                   'legal_outputs': sum(legal.values()), 'guided_rows': len(guided),
                   'greedy_rows_equal': len(greedy) - len(diffs),
                   'greedy_differences': diffs, 'margin_tol': GUIDED_MARGIN_TOL,
                   'bad_words_absent': no_banned,
                   'output_lengths': {k: statistics.mean(
                       len(tokens[i]) for i, (kk, _) in enumerate(GUIDED_ROWS) if kk == k)
                       for k in ('greedy', 'sampled', 'bad', 'plain')}},
        'launches': launches, 'launches_needed': need, 'launches_ok': launches_ok,
        'combines': combines, 'rows_by_kernel': {},
        **serving_numbers({'outs': outs, 't0': t0, 't1': t1})})
    guided_ok = (all(legal.values()) and within and no_banned and lengths_ok and replayed
                 and first['plain_host_rows'] == second['plain_host_rows'] == 0
                 and first['recovery_steps'] > 0 and launches_ok)
    engine.close()
    del engine, counters, outs, ref
    gc.collect()
    torch.cuda.empty_cache()
    seconds['guided'] = time.perf_counter() - t_g

    # -- S-LoRA ----------------------------------------------------------------------
    t_s = time.perf_counter()
    stamp = [time.perf_counter()]

    def lap(key):                   # the S-LoRA part's seconds, step by step
        now = time.perf_counter()
        seconds[key] = now - stamp[0]
        stamp[0] = now
    adapters = slora_adapters(model, SEED + 22)
    lap('slora_adapters')
    names = [None, 'a', 'b']
    which = [names[i % 3] for i in range(len(prompts))]
    rows_of = {n: [i for i, m in enumerate(which) if m == n] for n in names}
    # the S-LoRA engine sizes its KV cache from the free memory left after its leaves
    # and stacks, at the default fraction
    fraction = TpuEngineConfig().cache_max_entry_count
    engine = new_engine(adapters=adapters, num_blocks=0, cache_fraction=fraction)
    lap('slora_engine')
    agent = engine.model_agent
    budget = {'cache_fraction': fraction, 'num_blocks': agent.num_blocks,
              'stack_bytes': sum(t.numel() * t.element_size()
                                 for ab in agent.params['lora'].values() for t in ab.values()),
              'free_bytes_after_build': torch.cuda.mem_get_info()[0]}
    sl, _, _ = serve_rows(engine, prompts, [dict(max_new_tokens=GUIDED_NEW, ignore_eos=True,
                                                 adapter_name=n, logprobs=2) for n in which])
    lap('slora_serve')
    sl_graphs = agent.graphs.stats()
    served, slot_map, served_model = dict(agent.params), agent.lora_slot_map, agent.model
    engine.close()
    del engine, agent
    gc.collect()
    torch.cuda.empty_cache()
    base_engine = new_engine(env={'LMDEPLOY_TPU_FUSE_PROJ': '0'})
    lap('base_engine')
    plain_kws = [dict(max_new_tokens=GUIDED_NEW, ignore_eos=True, logprobs=2)] * len(prompts)
    base, _, _ = serve_rows(base_engine, prompts, plain_kws)
    lap('base_serve')
    graphs = base_engine.model_agent.graphs
    before, captured = graphs.stats(), {k: r.graph for k, r in graphs.runs.items()}
    merged = {}
    for name in ('a', 'b'):
        base_engine.load_lora(name, adapters[name])
        base_engine.activate_lora(name)
        merged[name], _, _ = serve_rows(base_engine, prompts, plain_kws)
    base_engine.deactivate_lora()
    restored, _, _ = serve_rows(base_engine, prompts, plain_kws)
    after = graphs.stats()
    base_engine.close()
    del base_engine
    gc.collect()
    torch.cuda.empty_cache()
    lap('merges')
    # each engine's own logprobs against f32 on the weights its rows were served with;
    # the traps serve the rows with another model (the adapter left out, as with
    # adapter_name=None or without activate_lora; the adapter where there is none)
    plans = {None: [('slora_rows', sl, rows_of[None], True),
                    ('unmerged_rows', restored, list(range(len(prompts))), True),
                    ('merged_a_rows', merged['a'], rows_of[None], False)],
             **{n: [('slora_rows', sl, rows_of[n], True),
                    ('merged_rows', merged[n], rows_of[n], True),
                    ('base_rows', base, rows_of[n], False)] for n in ('a', 'b')}}
    f32 = slora_f32_checks(served_model, served, slot_map, adapters, prompts, plans)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    lap('f32_checks')
    sl_tokens = [o.token_ids for o in sl]
    checks = {
        'base_rows': margin_differences(sl_tokens, base, rows_of[None], GUIDED_MARGIN_TOL),
        **{f'merged_{n}': margin_differences(sl_tokens, merged[n], rows_of[n],
                                             GUIDED_MARGIN_TOL) for n in ('a', 'b')},
        'unmerged': margin_differences([o.token_ids for o in restored], base,
                                       range(len(prompts)), GUIDED_MARGIN_TOL)}
    adapters_move = sum(sl_tokens[i] != base[i].token_ids for i, n in enumerate(which)
                        if n is not None)
    # the runs captured before the merges replay the merged leaves: the same graphs
    merge_replayed = (all(graphs.runs[k].graph is g for k, g in captured.items())
                      and after['eager_runs'] == 0 and after['replays'] > before['replays'])
    row['slora'] = {
        'ranks': SLORA_RANKS, 'budget': budget, 'graphs': sl_graphs, 'f32': f32,
        'adapter_rows_off_base': adapters_move,
        'merge_graphs_before_after': [before, after], 'merge_replayed': merge_replayed,
        **{k: {'differences': d, 'within': ok} for k, (d, ok) in checks.items()}}
    slora_ok = (f32['ok'] and merge_replayed and adapters_move > 0
                and sl_graphs['eager_runs'] == 0 and all(ok for _, ok in checks.values()))
    seconds['slora'] = time.perf_counter() - t_s
    row['seconds'] = seconds
    emit(row)
    if not (guided_ok and slora_ok):
        raise SystemExit(f'e2e_llama31_8b_guided_slora failed: {row}')
    return row


# -- logits, ppl and reward scores --------------------------------------------------------
# the scoring path: ModelAgent.compute_logits / compute_nll through AsyncEngine's
# async_get_logits / async_get_ppl / async_get_reward_score, prefill only (a text's
# first chunk on flash_prefill, later chunks over the cache on the gathered path)
PPL_TEXTS = 16                   # seeded texts of 256-2,048 ids, then one long text
PPL_LENS = (256, 2048)
PPL_LONG = 10000                 # 8,192 fresh, then 1,808 over a history of 8,192
PPL_SESSION = 10240
PPL_BLOCKS = 640
LOGITS_OF = (0, 8, PPL_TEXTS)    # the texts async_get_logits runs on, the long one last
PPL_SERVE = (64, 128, 32)        # the concurrent greedy batch: rows, prompt, tokens
# the engine's bf16 logits and per-position NLL against f32 on the same weights (the card's
# plain versions, one pass over each whole text).  The first card run read (H100 80GB
# HBM3, 700 W): logits 0.1084 / 0.1176 / 0.1456 over the three texts (10,000 x 128,256
# values the last), NLL 0.0884 over the 17 texts; the traps 9.910 (positions restart),
# 10.833 (history ignored), 7.766 nats (unshifted targets).  The allowances sit about 2x
# above the floor, 30x below the mildest trap
LOGITS_TOL = 0.3
NLL_TOL = 0.2
PPL_TRAPS = ('positions_restart', 'history_ignored', 'nll_unshifted')
PPL_REPORTED = ()
# the published configs of two reward models (the config.json fields the port reads)
QWEN25_MATH_RM_72B = {
    'architectures': ['Qwen2ForRewardModel'], 'model_type': 'qwen2',
    'hidden_size': 8192, 'intermediate_size': 29568, 'num_hidden_layers': 80,
    'num_attention_heads': 64, 'num_key_value_heads': 8, 'vocab_size': 152064,
    'max_position_embeddings': 4096, 'rms_norm_eps': 1e-06, 'rope_theta': 1000000.0,
    'tie_word_embeddings': False, 'torch_dtype': 'bfloat16'}
INTERNLM2_7B_REWARD = {
    'architectures': ['InternLM2ForRewardModel'], 'model_type': 'internlm2',
    'hidden_size': 4096, 'intermediate_size': 14336, 'num_hidden_layers': 32,
    'num_attention_heads': 32, 'num_key_value_heads': 8, 'vocab_size': 92544,
    'max_position_embeddings': 32768, 'rms_norm_eps': 1e-05, 'rope_theta': 1000000.0,
    'bias': False, 'tie_word_embeddings': False, 'torch_dtype': 'bfloat16'}
REWARD_CONFIGS = {'qwen25_math_rm_72b': QWEN25_MATH_RM_72B,
                  'internlm2_7b_reward': INTERNLM2_7B_REWARD}
LREWARD = 2
REWARD_PROMPTS = 16
REWARD_LENS = (64, 2048)
# bf16 scores against f32 on the same weights, relative to the f32 scores' spread (their
# std over the 16 prompts).  The first card run read 0.0576 (Qwen2.5-Math-RM-72B, spread
# 2.03) and 0.0261 (internlm2-7b-reward, spread 1.21); the traps 2.41 (ReLU left out),
# 2.61 and 4.23 (the first position's score); h left unrounded before w2 read 0.0585, the
# floor itself (it moves only bf16 rounding), so it is reported, not held
REWARD_TOL = 0.15
REWARD_TRAPS = {'qwen25_math_rm_72b': ('relu_left_out', 'first_position', 'h_unrounded'),
                'internlm2_7b_reward': ('first_position',)}
REWARD_REPORTED = ('h_unrounded',)


def _f32_logits(model32, tree32, ids) -> torch.Tensor:
    """f32 logits [T, V] of one whole text in one pass on the card (the plain
    versions, TF32 off, the gathered attention over the text at once): the reference
    the chunked scoring path is held against."""
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    cfg = model32.config
    T, BS, dev = len(ids), 128, tree32['embed'].device
    W = -(-T // BS)
    cache = torch.zeros((cfg.num_layers, 1 + W, 2, BS, cfg.num_key_value_heads * cfg.head_dim),
                        dtype=torch.float32, device=dev)
    cos, sin = make_rope_table(cfg.rope_dim, W * BS, cfg.rope_theta, cfg.rope_scaling,
                               device=dev)
    meta = AttnMeta(block_tables=torch.arange(1, 1 + W, dtype=torch.int32, device=dev)[None],
                    history_lens=torch.zeros(1, dtype=torch.int32, device=dev),
                    q_lens=torch.tensor([T], dtype=torch.int32, device=dev))
    ids_t = torch.tensor([ids], dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    with _plain_kernels(), torch.no_grad():
        return model32.forward(tree32, ids_t, pos, cache, meta, cos, sin,
                               return_all_logits=True)[0]


def _nll_ref(logits: torch.Tensor, targets: torch.Tensor, rows: int = 1024) -> torch.Tensor:
    """f64 NLL of ``targets`` under ``logits`` rows, by log_softmax in f64, in row tiles."""
    out = [-torch.log_softmax(logits[i:i + rows].double(), -1)
           .gather(1, targets[i:i + rows, None])[:, 0]
           for i in range(0, logits.shape[0], rows)]
    return torch.cat(out)


def _scratch(engine, n):
    """Scratch blocks for ``n`` tokens from the engine's block manager (freed by the
    caller), as ``AsyncEngine`` lends them."""
    bm = engine.scheduler.block_manager
    return bm.allocate(-(-n // bm.block_size))


def _score_vs(agent, ids, blocks, ref, trap_targets=None) -> dict:
    """The scoring path's chunks of ``ids`` against the f32 logits ``ref`` on the card:
    the max |logits - ref| over all rows and over the rows of the second chunk on, and,
    with ``trap_targets``, the NLL of those targets under the chunks' logits."""
    out = {'logits': 0.0, 'later_chunks': 0.0}
    nll = []
    # ``ref`` and the targets were made on this stream, the chunks run on the agent's
    torch.cuda.synchronize()

    def take(lg, start):
        err = (lg - ref[start:start + lg.shape[0]]).abs().max().item()
        out['logits'] = max(out['logits'], err)
        if start > 0:
            out['later_chunks'] = max(out['later_chunks'], err)
        if trap_targets is not None:
            rows = min(lg.shape[0], len(trap_targets) - start)
            nll.append(_nll_ref(lg[:rows], trap_targets[start:start + rows]))
    agent._score_chunks(ids, blocks, take)
    torch.cuda.synchronize()
    if trap_targets is not None:
        out['nll'] = torch.cat(nll)
    return out


def _ppl_trap(agent, trap: str):
    """Swaps that plant a scoring-path trap into the model's forward: the second
    chunk's positions restart at 0, or the second chunk attends only to itself (its
    history taken as 0: it also writes its KV over the first chunk's); none for the
    NLL trap, which takes each position's own token as its target."""
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    forward = agent.model.forward

    def restarted(params, ids, pos, cache, meta, *args, **kwargs):
        return forward(params, ids, (pos - meta.history_lens[:, None]).clamp_min(0),
                       cache, meta, *args, **kwargs)

    def no_history(params, ids, pos, cache, meta, *args, **kwargs):
        meta = AttnMeta(block_tables=meta.block_tables,
                        history_lens=torch.zeros_like(meta.history_lens), q_lens=meta.q_lens)
        return forward(params, ids, pos, cache, meta, *args, **kwargs)
    fn = {'positions_restart': restarted, 'history_ignored': no_history}.get(trap)
    return _swapped(*([(agent.model, 'forward', fn)] if fn else []))


def _zero_counts(engine):
    for fn in _kernel_counters().values():
        fn.launches = 0
        if hasattr(fn, 'combines'):
            fn.combines = 0
    engine.model_agent.graphs.reset_counts()


def _counts(engine):
    launches, combines = engine.model_agent.graphs.launch_totals()
    counters = _kernel_counters()
    return ({n: launches[fn.__name__] for n, fn in counters.items()},
            {n: combines[fn.__name__] for n, fn in counters.items() if hasattr(fn, 'combines')})


def _device_ms(agent, fn):
    """(result, device ms) of ``fn()``, which queues its work on the agent's stream."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(agent.stream)
    out = fn()
    end.record(agent.stream)
    end.synchronize()
    return out, start.elapsed_time(end)


def ppl_logits_cell(card: str, shared: dict) -> dict:
    """Llama-3.1-8B at L31 layers on the shared seeded bf16 weights, session 10,240,
    chunks of 8,192: ``async_get_ppl`` over PPL_TEXTS seeded texts and one of PPL_LONG
    ids, ``async_get_logits`` over three of them (the long one too), every per-position
    NLL and the logits held against f32 with the traps of PPL_TRAPS; launches exact (one
    flash_prefill a layer of each text's first chunk, no other kernel); then PPL_SERVE's
    greedy batch alone and with the 17 ppl requests issued while it decodes on graphs:
    the same tokens, and the same ppl bit for bit."""
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
    model = llama31_config(L31)
    V = model.vocab_size
    seconds = {}
    stamp = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        seconds[key] = now - stamp[0]
        stamp[0] = now
    rng = np.random.RandomState(SEED + 30)
    texts = [rng.randint(3, 128000, size=n).tolist()
             for n in rng.randint(PPL_LENS[0], PPL_LENS[1] + 1, size=PPL_TEXTS)]
    texts.append(rng.randint(3, 128000, size=PPL_LONG).tolist())
    engine, build_s = _built(model, PPL_SERVE[0], 0, PPL_SESSION - 128, 1, shared, None,
                             num_blocks=PPL_BLOCKS)
    agent = engine.model_agent
    warm = _warmed(engine, PPL_SERVE[0])
    aeng = AsyncEngine.from_engine(engine)
    lap('engine')

    # -- the scoring traffic, idle engine: launches counted ---------------------------
    _zero_counts(engine)
    t0 = time.perf_counter()
    ppl = asyncio.run(aeng.async_get_ppl(texts))
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    launches, combines = _counts(engine)
    lap('ppl')
    _zero_counts(engine)
    t0 = time.perf_counter()
    host_logits = asyncio.run(aeng.async_get_logits([texts[i] for i in LOGITS_OF]))
    logits_s = time.perf_counter() - t0
    logits_launches, _ = _counts(engine)
    lap('logits')
    need = {'flash_prefill': L31 * len(texts)}
    need_logits = {'flash_prefill': L31 * len(LOGITS_OF)}
    launches_ok = all(launches[n] == need.get(n, 0) for n in launches) and all(
        logits_launches[n] == need_logits.get(n, 0) for n in logits_launches)
    long_ids = texts[-1]
    blocks = _scratch(engine, PPL_LONG)
    # the long text's device time: its chunks' forward with the f32 logits, then the
    # NLL path (the forward, the f64 log-sum-exp and the [T] copy)
    _, forward_ms = _device_ms(agent, lambda: agent._score_chunks(long_ids, blocks,
                                                                   lambda lg, start: None))
    long_nll, nll_ms = _device_ms(agent, lambda: agent.compute_nll(long_ids, blocks))
    t0 = time.perf_counter()
    agent.compute_logits(long_ids, blocks)
    logits_to_host_s = time.perf_counter() - t0
    engine.scheduler.block_manager.free(blocks)
    lap('device_ms')

    # -- against f32 on the same weights ------------------------------------------------
    m32 = build_model(dataclasses.replace(model, dtype='float32'))
    tree32 = _bf16_tree(agent.params, agent.device, torch.float32)
    lap('f32_tree')
    nll_err, ppl_err, logits_err = [], [], {}
    for i, ids in enumerate(texts):
        ref = _f32_logits(m32, tree32, ids)
        tgt = torch.tensor(ids[1:], device=agent.device)
        ref_nll = _nll_ref(ref[:-1], tgt)
        blocks = _scratch(engine, len(ids))
        got = torch.from_numpy(agent.compute_nll(ids, blocks)).to(agent.device)
        nll_err.append((got - ref_nll).abs().max().item())
        ppl_err.append(abs(ppl[i] - ref_nll.mean().item()))
        if i in LOGITS_OF:
            host = host_logits[LOGITS_OF.index(i)]
            logits_err[i] = max((torch.from_numpy(host[j:j + 1024]).to(agent.device)
                                 - ref[j:j + 1024]).abs().max().item()
                                for j in range(0, len(ids), 1024))
        if i == len(texts) - 1:
            # the traps, planted in the scoring path of the long text
            traps = {}
            for trap in PPL_TRAPS:
                with _ppl_trap(agent, trap):
                    out = _score_vs(agent, ids, blocks, ref,
                                    torch.tensor(ids[:-1], device=agent.device)
                                    if trap == 'nll_unshifted' else None)
                if trap == 'nll_unshifted':
                    traps[trap] = {'nll': (out['nll'] - ref_nll).abs().max().item()}
                else:
                    traps[trap] = {'logits': out['later_chunks']}
            sound = _score_vs(agent, ids, blocks, ref)
        engine.scheduler.block_manager.free(blocks)
        del ref
    del tree32
    gc.collect()
    torch.cuda.empty_cache()
    lap('f32_checks')
    nll_ok = max(nll_err) <= NLL_TOL
    logits_ok = max(logits_err.values()) <= LOGITS_TOL and sound['logits'] <= LOGITS_TOL
    held = {t: r for t, r in traps.items() if t not in PPL_REPORTED}
    traps_ok = all(r.get('logits', r.get('nll')) > (LOGITS_TOL if 'logits' in r else NLL_TOL)
                   for r in held.values())

    # -- served tokens with the ppl requests issued while the batch decodes ------------
    n, plen, new = PPL_SERVE
    prompts = [rng.randint(3, 128000, size=plen).tolist() for _ in range(n)]
    kws = [dict(max_new_tokens=new, ignore_eos=True)] * n
    alone, _, _ = serve_rows(engine, prompts, kws)
    lap('serve_alone')
    from lmdeploy_tpu_torch.messages import GenerationConfig
    agent.graphs.reset_counts()

    async def mixed():
        inst = engine.create_instance()
        serving = [asyncio.ensure_future(inst.async_infer(1000 + i, p, GenerationConfig(**kw)))
                   for i, (p, kw) in enumerate(zip(prompts, kws))]
        # the batch is decoding: its first rows are prefilled (the prefill steps take
        # 16 rows each) and none has finished
        while not engine.scheduler.running and not any(s.done() for s in serving):
            await asyncio.sleep(0.001)
        t_issue = time.time()
        scored = await asyncio.gather(*[aeng.async_get_ppl([t]) for t in texts])
        outs = await asyncio.gather(*serving)
        return outs, [s[0] for s in scored], t_issue, time.time()
    outs, ppl_mixed, t_issue, t_end = asyncio.run(mixed())
    torch.cuda.synchronize()
    mixed_graphs = agent.graphs.stats()
    lap('serve_with_ppl')
    tokens_equal = [o.token_ids for o in outs] == [o.token_ids for o in alone]
    ppl_equal = ppl_mixed == ppl
    overlapped = sum(o.req_metrics.finish_time > t_issue for o in outs)
    replayed = mixed_graphs['eager_runs'] == 0 and mixed_graphs['replays'] > 0
    engine.close()
    del engine, agent, aeng
    gc.collect()
    torch.cuda.empty_cache()
    row = {'cell': 'llama31_8b_ppl_logits', 'model': model_label(model), 'card': card,
           'texts': [len(t) for t in texts], 'chunk_tokens': 8192,
           'engine_build_s': build_s, 'warmup': warm,
           'ppl': ppl, 'ppl_s': ppl_s, 'logits_s': logits_s,
           'long_text': {'tokens': PPL_LONG, 'forward_device_ms': forward_ms,
                         'nll_device_ms': nll_ms, 'logits_to_host_s': logits_to_host_s,
                         'logits_bytes': PPL_LONG * V * 4,
                         'nll_bytes_to_host': (PPL_LONG - 1) * 8,
                         'nll_mean': float(long_nll.mean())},
           'launches': launches, 'combines': combines, 'launches_needed': need,
           'logits_launches': logits_launches, 'logits_launches_needed': need_logits,
           'launches_ok': launches_ok,
           'nll_max_abs_err': max(nll_err), 'ppl_max_abs_err': max(ppl_err),
           'logits_max_abs_err': {str(k): v for k, v in logits_err.items()},
           'logits_scoring_path_max_abs_err': sound['logits'],
           'nll_tol': NLL_TOL, 'logits_tol': LOGITS_TOL, 'traps': traps,
           'traps_reported': list(PPL_REPORTED), 'traps_ok': traps_ok,
           'serve': {'rows': n, 'prompt': plen, 'new_tokens': new,
                     'tokens_equal_alone': tokens_equal, 'ppl_equal_idle': ppl_equal,
                     'rows_finished_after_ppl_issued': overlapped,
                     'ppl_issue_to_end_s': t_end - t_issue, 'graphs': mixed_graphs},
           'seconds': seconds}
    row['ok'] = (launches_ok and nll_ok and logits_ok and traps_ok and tokens_equal
                 and ppl_equal and overlapped == n and replayed
                 and all(np.isfinite(p) for p in ppl)
                 and [h.shape for h in host_logits] == [(len(texts[i]), V) for i in LOGITS_OF])
    return row


def _reward_trapped(trap: str):
    """Swaps of the Qwen2 score head: ReLU left out, or h not rounded to the model
    dtype before w2 (the first-position trap reads the scores' rows instead)."""
    from lmdeploy_tpu_torch.models.reward import Qwen2RewardModel

    def head(self, params, x):
        h = torch.matmul(x.float(), params['score_w1'].float()) + params['score_b1'].float()
        if trap != 'relu_left_out':
            h = torch.relu(h)
        if trap != 'h_unrounded':
            h = h.to(x.dtype)
        return torch.matmul(h.float(), params['score_w2'].float()) + params['score_b2'].float()
    return _swapped(*([(Qwen2RewardModel, '_head', head)]
                      if trap in ('relu_left_out', 'h_unrounded') else []))


def reward_cell(name: str, card: str) -> dict:
    """One reward model of REWARD_CONFIGS at LREWARD layers, seeded bf16 weights:
    ``async_get_reward_score`` over REWARD_PROMPTS seeded prompts of REWARD_LENS ids,
    held against f32 on the same weights relative to the f32 scores' spread, with its
    traps; one flash_prefill a layer a prompt, no other kernel."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
    model = ModelConfig.from_hf_config(dict(REWARD_CONFIGS[name], num_hidden_layers=LREWARD))
    rng = np.random.RandomState(SEED + 31)
    prompts = [rng.randint(3, model.vocab_size, size=n).tolist()
               for n in rng.randint(REWARD_LENS[0], REWARD_LENS[1] + 1, size=REWARD_PROMPTS)]
    t0 = time.perf_counter()
    engine = build_engine(model, REWARD_PROMPTS, session_len=REWARD_LENS[1] + 128,
                          num_blocks=REWARD_PROMPTS * 17)
    aeng = AsyncEngine.from_engine(engine)
    build_s = time.perf_counter() - t0
    _zero_counts(engine)
    t0 = time.perf_counter()
    scores = asyncio.run(aeng.async_get_reward_score(prompts))
    torch.cuda.synchronize()
    scores_s = time.perf_counter() - t0
    launches, combines = _counts(engine)
    need = {'flash_prefill': LREWARD * len(prompts)}
    launches_ok = all(launches[n] == need.get(n, 0) for n in launches)
    agent = engine.model_agent
    m32 = build_model(dataclasses.replace(model, dtype='float32'))
    tree32 = _bf16_tree(agent.params, agent.device, torch.float32)
    ref = [_f32_logits(m32, tree32, ids)[-1, 0].item() for ids in prompts]
    del tree32
    gc.collect()
    torch.cuda.empty_cache()
    spread = float(np.std(ref))
    err = float(np.max(np.abs(np.subtract(scores, ref)))) / spread
    traps = {}
    for trap in REWARD_TRAPS[name]:
        if trap == 'first_position':
            got = [float(x[0, 0]) for x in asyncio.run(aeng.async_get_logits(prompts))]
        else:
            with _reward_trapped(trap):
                got = asyncio.run(aeng.async_get_reward_score(prompts))
        traps[trap] = float(np.max(np.abs(np.subtract(got, ref)))) / spread
    engine.close()
    del engine, agent, aeng
    gc.collect()
    torch.cuda.empty_cache()
    held = {t: r for t, r in traps.items() if t not in REWARD_REPORTED}
    row = {'cell': f'reward_{name}', 'model': model_label(model), 'card': card,
           'prompts': [len(p) for p in prompts], 'engine_build_s': build_s,
           'scores_s': scores_s, 'scores': scores, 'f32_scores': ref, 'spread': spread,
           'max_err_over_spread': err, 'tol': REWARD_TOL, 'traps': traps,
           'traps_reported': [t for t in traps if t in REWARD_REPORTED],
           'launches': launches, 'combines': combines, 'launches_needed': need,
           'launches_ok': launches_ok}
    row['ok'] = (launches_ok and err <= REWARD_TOL and all(v > REWARD_TOL for v in held.values())
                 and all(np.isfinite(scores)) and len(set(scores)) == len(scores))
    return row


def logits_ppl_reward_phase(card: str, shared: dict) -> dict:
    """logits_ppl_reward: the scoring path (``ppl_logits_cell``, on the shared
    Llama-3.1-8B weights, before the guided cell writes into them; ``reward_cell`` for
    Qwen2.5-Math-RM-72B and internlm2-7b-reward).  Returns the phase's row, whose
    launches are the ppl traffic's."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the f32 references stay f32
    t0 = time.perf_counter()
    ppl = ppl_logits_cell(card, shared)
    emit(ppl)
    rewards = {}
    for name in REWARD_CONFIGS:
        rewards[name] = reward_cell(name, card)
        emit(rewards[name])
    row = {'phase': 'logits_ppl_reward', 'card': card, 'launches': ppl['launches'],
           'combines': ppl['combines'], 'rows_by_kernel': {},
           'reward_launches': {n: r['launches'] for n, r in rewards.items()},
           'seconds': {'ppl_logits': ppl['seconds'], 'total': time.perf_counter() - t0,
                       **{n: r['engine_build_s'] + r['scores_s'] for n, r in rewards.items()}}}
    emit(row)
    failed = [r['cell'] for r in (ppl, *rewards.values()) if not r['ok']]
    if failed:
        raise SystemExit(f'logits_ppl_reward failed: {failed}')
    return row


def kernel_line(flash, decode, decode8, w4, mx, kv, szc, unprep, fp8, cp, mla_quant):
    def entry(name, source, replaces, rows, lead, library_ms):
        return {'name': name, 'route': 'cuda', 'source': f'lmdeploy_tpu_torch/csrc/{source}',
                'replaces': replaces, 'launches': None,
                'max_abs_err': max(r['max_abs_err'] for r in rows), 'ms': lead['kernel_ms'],
                'plain_ms': lead['plain_ms'], 'bound_ms': lead['bound_ms'],
                'bound_by': lead['bound_by'], 'library_ms': library_ms}
    # the main-path shape of each kernel: T=2048 prefill, bs64 decode, bs64 7b int8
    # decode, and the W4A16 GEMM summed over one llama2-7b layer's four projections
    # at the e2e phase's M (times and bounds both)
    layer = [r for r in w4 if r['shape'][0] == W4_MAIN_M]
    w4_lead = {k: sum(r[k] for r in layer) for k in ('kernel_ms', 'plain_ms', 'bound_ms')}
    w4_lead['bound_by'] = 'bytes' if all(r['bound_by'] == 'bytes' for r in layer) \
        else 'operations'
    lib = [r['library_ms'] for r in layer]
    # MXFP4: one gpt-oss-20b layer's three expert products (gate, up: shared x; down:
    # x per expert) at the e2e decode bucket
    mx_main = {r['case']: r for r in mx if r['shape'][1] == MX_MAIN_M}
    mx_layer = [mx_main[f'gate_m{MX_MAIN_M}']] * 2 + [mx_main[f'down_m{MX_MAIN_M}']]
    mx_lead = {k: sum(r[k] for r in mx_layer) for k in ('kernel_ms', 'plain_ms', 'bound_ms')}
    mx_lead['bound_by'] = 'bytes' if all(r['bound_by'] == 'bytes' for r in mx_layer) \
        else 'operations'
    # the KV policies' decode kernels: the e2e_llama31 decode shape
    kv_lead = {name: next(r for r in rows if r['case'] == 'e2e_shape_llama31')
               for name, rows in kv.items()}
    kv_entries = [
        dict(entry(name, source, f'lmdeploy_tpu/ops/pallas/paged_decode.py:{line}', kv[name],
                   kv_lead[name], None),
             shape='e2e_llama31 decode: B 64, Hq 32, Hkv 8, D 128, BS 128, '
                   f'{kv_lead[name]["mean_kv_len"]:.0f} mean kv tokens')
        for name, source, line in (('paged_decode_int4', 'paged_decode_int4.cu', 499),
                                   ('paged_decode_turbo', 'paged_decode_turbo.cu', 371),
                                   ('paged_decode_fp8', 'paged_decode.cu', 155))]
    for e in kv_entries:
        lead = kv_lead[e['name']]
        if 'split_tokens_ms' in lead:
            e.update({k: lead[k] for k in ('path', 'split_tokens', 'splits',
                                           'split_tokens_ms')})
    # the fast / precise and unprepared W4A16 GEMMs: one Mixtral-8x7B layer's fused
    # wqkv and wo at the e2e_mixtral phases' decode bucket (fast's times lead, precise's
    # beside them)
    mix = [n for n, _, _ in MIX_LAYER]
    shape = f'mixtral-8x7b layer: wqkv + wo at M = {MIX_MAIN_M}'
    fast = _layer_lead([r for r in szc if r['mode'] == 'fast'], mix, MIX_MAIN_M)
    precise = _layer_lead([r for r in szc if r['mode'] == 'precise'], mix, MIX_MAIN_M)
    raw = _layer_lead(unprep, mix, MIX_MAIN_M)
    # fp8_bmm: one DeepSeek-V2-Lite layer's three expert products (gate, up: x shared;
    # down: x per expert) at the e2e decode bucket
    fp8_main = {r['case']: r for r in fp8}
    fp8_layer = [fp8_main[f'v2_lite_gate_m{FP8_MAIN_M}']] * 2 \
        + [fp8_main[f'v2_lite_down_m{FP8_MAIN_M}']]
    fp8_lead = {k: sum(r[k] for r in fp8_layer) for k in ('kernel_ms', 'plain_ms', 'bound_ms')}
    fp8_lead['bound_by'] = 'bytes' if all(r['bound_by'] == 'bytes' for r in fp8_layer) \
        else 'operations'
    v3 = [fp8_main[f'v3_gate_m{FP8_MAIN_M}']] * 2 + [fp8_main[f'v3_down_m{FP8_MAIN_M}']]
    v3_verify = [fp8_main['v3_gate_m320']] * 2 + [fp8_main['v3_down_m320']]

    def shapes(rows, prefix):
        """The MLA rows of an attention kernel, by case."""
        return {r['case']: {k: r[k] for k in ('shape', 'kernel_ms', 'plain_ms', 'bound_ms',
                                              'bound_by', 'library_ms', 'max_abs_err')}
                for r in rows if r['case'].startswith(prefix)}
    for e in kv_entries:
        if e['name'] in mla_quant:
            e['mla'] = shapes(mla_quant[e['name']], 'mla')
    # the context-parallel decode: the e2e_llama31_8b_cp2 cell's decode shape at cp 2
    # (its other cases beside it, each with the single-rank paged_decode's time)
    cp_lead = next(r for r in cp if r['case'] == 'e2e_cp2')
    cp_entry = dict(
        entry('paged_decode_cp', 'paged_decode_cp.cu',
              'lmdeploy_tpu/ops/pallas/paged_decode.py:725', cp, cp_lead, None),
        shape=f'e2e_llama31_8b_cp2 decode: B 32, Hq 32, Hkv 8, D 128, BS 128, cp 2 on one '
              f'card, {cp_lead["mean_kv_len"]:.0f} mean kv tokens, one row of '
              f'{cp_lead["max_kv_len"]}',
        single_rank_paged_decode_ms=cp_lead['single_rank_paged_decode_ms'],
        **{k: cp_lead[k] for k in ('path', 'splits', 'partials_ms', 'combine_ms',
                                   'split_tokens_ms')},
        cases={r['case']: {k: r[k] for k in ('cp', 'shape', 'dtype', 'path', 'splits',
                                             'kernel_ms', 'plain_ms', 'partials_ms',
                                             'combine_ms', 'single_rank_paged_decode_ms',
                                             'bound_ms', 'bound_by', 'max_abs_err')}
               for r in cp})
    return kv_entries + [cp_entry,
        dict(entry('fp8_bmm', 'fp8_bmm.cu', 'lmdeploy_tpu/ops/pallas/quant_bmm.py:153', fp8,
                   fp8_lead, None),
             dense_bf16_ms=sum(r['dense_bf16_ms'] for r in fp8_layer),
             library=fp8_layer[0]['library'],
             shape=f'deepseek-v2-lite layer: gate + up (x shared) + down (x per expert), '
                   f'E {FP8_V2L[0]}, H {FP8_V2L[1]}, Ie {FP8_V2L[2]}, group 128, '
                   f'M = {FP8_MAIN_M}',
             v3_layer={k: sum(r[k] for r in v3) for k in ('kernel_ms', 'plain_ms',
                                                           'bound_ms', 'dense_bf16_ms')},
             v3_verify_layer={k: sum(r[k] for r in v3_verify)
                              for k in ('kernel_ms', 'plain_ms', 'bound_ms', 'dense_bf16_ms')}),
        dict(entry('w4a16_szc', 'w4a16_gemm_szc.cu',
                   'lmdeploy_tpu/ops/pallas/quant_matmul.py:364', szc, fast,
                   fast['library_ms']),
             dense_bf16_ms=fast['dense_bf16_ms'], precise_ms=precise['kernel_ms'],
             precise_plain_ms=precise['plain_ms'], precise_bound_ms=precise['bound_ms'],
             shape=shape + ' (fast; precise_* the precise schedule)'),
        dict(entry('w4a16_unprepared', 'w4a16_gemm_unprepared.cu',
                   'lmdeploy_tpu/ops/pallas/quant_matmul.py:91', unprep, raw,
                   raw['library_ms']),
             dense_bf16_ms=raw['dense_bf16_ms'], shape=shape),
        dict(entry('flash_prefill', 'flash_prefill.cu',
                   'lmdeploy_tpu/ops/pallas/flash_prefill.py:76', flash, flash[0],
                   flash[0]['library_ms']), mla=shapes(flash, 'mla'),
             qwen3_next=shapes(flash, 'qwen3_next')),
        dict(entry('paged_decode', 'paged_decode.cu',
                   'lmdeploy_tpu/ops/pallas/paged_decode.py:866', decode, decode[0], None),
             **{k: decode[0][k] for k in ('path', 'split_tokens', 'splits', 'split_tokens_ms')},
             shape=f'bs64 TinyLlama heads: B 64, Hq 32, Hkv 4, D 64, BS 128, '
                   f'{decode[0]["mean_kv_len"]:.0f} mean kv tokens',
             mla=shapes(decode, 'mla'), qwen3_next=shapes(decode, 'qwen3_next'),
             cases={r['case']: {k: r.get(k) for k in ('shape', 'dtype', 'path', 'splits',
                                                      'kernel_ms', 'bound_ms', 'max_abs_err',
                                                      'split_tokens_ms')} for r in decode}),
        dict(entry('paged_decode_int8', 'paged_decode_int8.cu',
                   'lmdeploy_tpu/ops/pallas/paged_decode.py:286', decode8, decode8[0], None),
             **{k: decode8[0][k] for k in ('path', 'split_tokens', 'splits', 'split_tokens_ms')},
             shape=f'bs64 llama2-7b heads: B 64, Hq 32, Hkv 32, D 128, BS 128, '
                   f'{decode8[0]["mean_kv_len"]:.0f} mean kv tokens',
             mla=shapes(mla_quant['paged_decode_int8'], 'mla'),
             cases={r['case']: {k: r.get(k) for k in ('shape', 'dtype', 'path', 'splits',
                                                      'kernel_ms', 'bound_ms', 'max_abs_err',
                                                      'split_tokens_ms')} for r in decode8}),
        dict(entry('w4a16_gemm', 'w4a16_gemm.cu',
                   'lmdeploy_tpu/ops/pallas/quant_matmul.py:392', w4, w4_lead,
                   sum(lib) if None not in lib else None),
             dense_bf16_ms=sum(r['dense_bf16_ms'] for r in layer),
             shape=f'llama2-7b layer: wqkv + wo + w_gateup + w_down at M = {W4_MAIN_M}'),
        dict(entry('mxfp4_bmm', 'mxfp4_bmm.cu',
                   'lmdeploy_tpu/ops/pallas/quant_bmm.py:203', mx, mx_lead, None),
             dense_bf16_ms=sum(r['dense_bf16_ms'] for r in mx_layer),
             library=mx_layer[0]['library'],
             shape=f'gpt-oss-20b layer: gate + up (x shared) + down (x per expert), E = '
                   f'{MX_E}, K = N = {MX_H}, M = {MX_MAIN_M}',
             cases={r['case']: {k: r[k] for k in ('shape', 'token_tile', 'kernel_ms',
                                                  'bound_ms', 'bound_by', 'dense_bf16_ms',
                                                  'max_abs_err')}
                    for r in mx if 'kernel_ms' in r}),
    ]


def main():
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    seconds = {}
    t_start = time.perf_counter()

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t0, 1)
        # as each phase ends, so that a run cut short still says where its time went
        emit({'phase': 'seconds', 'of': name, 's': seconds[name],
              'since_start_s': round(time.perf_counter() - t_start, 1)})
        return out
    info = device_phase()
    timed('build', build_phase)
    kernels = kernel_line(timed('flash_prefill', flash_phase), timed('paged_decode', decode_phase),
                          timed('paged_decode_int8', decode_int8_phase),
                          timed('w4a16_gemm', w4a16_phase), timed('mxfp4_bmm', mxfp4_phase),
                          timed('paged_decode_kv', decode_kv_phase),
                          *timed('w4a16_szc_unprepared', w4a16_modes_phase),
                          timed('fp8_bmm', fp8_phase), timed('paged_decode_cp', decode_cp_phase),
                          timed('paged_decode_mla_quant', decode_mla_quant_phase))
    timed('int_mm', int_mm_phase, info['nvidia_smi'])
    timed('routing_ties', routing_ties_phase, info['nvidia_smi'])
    timed('fp8_bmm_groups', fp8_groups_phase)
    timed('paged_decode_small_pages', decode_small_pages_phase)
    timed('parity', parity_phase, 'parity', tinyllama_config(num_layers=2), LOGIT_TOL)
    timed('parity_w4a16_kv8', parity_phase, 'parity_w4a16_kv8',
          llama7b_w4_config(num_layers=2), LOGIT_TOL_W4, policy=4)
    timed('parity_gptoss', parity_phase, 'parity_gptoss', gptoss_config(num_layers=2),
          LOGIT_TOL_GPTOSS)
    for policy, tol in LOGIT_TOL_KV.items():
        name = f'parity_llama31_{KV_PHASE[policy]}'
        timed(name, parity_phase, name, llama31_config(num_layers=2), tol, policy=policy)
    timed('parity_llama31_8b_cp2', parity_phase, 'parity_llama31_8b_cp2',
          llama31_config(num_layers=2), LOGIT_TOL_CP, cp=2)
    for sched, tol in LOGIT_TOL_MIXTRAL.items():
        name = 'parity_mixtral_w4a16' + ('' if sched == 'gd' else f'_{sched}')
        timed(name, parity_phase, name, mixtral_config(num_layers=2), tol, schedule=sched)
    timed('parity_deepseek_v2_lite', parity_phase, 'parity_deepseek_v2_lite',
          deepseek_config(num_layers=2), LOGIT_TOL_DEEPSEEK)
    for policy, tol in LOGIT_TOL_DEEPSEEK_KV.items():
        name = f'parity_deepseek_v2_lite_kv{8 if policy == 4 else 4}'
        timed(name, parity_phase, name, deepseek_config(num_layers=2), tol, policy=policy)
    for fmt, tol in LOGIT_TOL_W8.items():
        name = f'parity_{W8_PHASE[fmt]}'
        timed(name, parity_phase, name, w8_config(fmt, 2), tol)
    for family, tol in LOGIT_TOL_MOE.items():
        name = f'parity_{family}'
        timed(name, parity_phase, name, moe_config(family, 2), tol)
    for family, tol in LOGIT_TOL_DENSE.items():
        name = f'parity_{family}'
        timed(name, parity_phase, name, dense_config(family, 2), tol)
    _PARITY_WEIGHTS.clear()
    L1, L7 = tinyllama_config(LTINY).num_layers, LW4
    # launches each (prefill step, decode step) needs on each path, and the path whose
    # launches each kernel's entry reports; the Llama-3.1-8B phases share one set of
    # seeded weights and must launch exactly that many
    shared = {}
    paths = {}
    for policy in KV_POLICIES:
        name = f'e2e_llama31_8b_{KV_PHASE[policy]}'
        # the int4, TurboQuant and e4m3 decodes split every call at the 33-page table,
        # each call a second launch for the combine, counted apart from the decode's own
        paths[name] = timed(name, e2e_phase, name, llama31_config(L31), 64, policy, 63,
                            {'flash_prefill': (L31, 0), KV_POLICIES[policy]: (0, L31)},
                            info['nvidia_smi'], short_len=1024, long_len=4096, exact=True,
                            shared=shared, combined={
                                k: 1 for k in (KV_POLICIES[policy],) if k in KV_SPLIT_CONST})
    # the same weights with the KV striped over two context-parallel ranks on the one
    # card: 31 x 1,024 tokens and one 16,384-token prompt, the traffic users turn CP on
    # for; each decode step launches the partial kernel once a layer on each rank
    paths['e2e_llama31_8b_cp2'] = timed(
        'e2e_llama31_8b_cp2', e2e_phase, 'e2e_llama31_8b_cp2', llama31_config(L31), 32, 0, 31,
        {'flash_prefill': (L31, 0), 'paged_decode_cp': (0, 2 * L31)}, info['nvidia_smi'],
        short_len=1024, long_len=16384, exact=True, shared=shared, forbid=('paged_decode',),
        cp=2, combined={'paged_decode_cp': 1}, graphs_check={})
    # logits, ppl and reward scores: the scoring path on the same weights, then two
    # reward models
    paths['logits_ppl_reward'] = timed('logits_ppl_reward', logits_ppl_reward_phase,
                                       info['nvidia_smi'], shared)
    # guided decoding, bad words and S-LoRA on the same weights (the last cell to use them:
    # its merge path writes into the unfused leaves it shares)
    paths['e2e_llama31_8b_guided_slora'] = timed(
        'e2e_llama31_8b_guided_slora', guided_slora_phase, info['nvidia_smi'], shared)
    shared.clear()
    # the narrow decode splits every call at the 17-page table (its combine counted in
    # paged_decode's .combines) in the TinyLlama, gpt-oss and Mixtral cells, but for
    # gpt-oss's sliding layers, whose 128-token window fits one split
    paths['e2e'] = timed('e2e', e2e_phase, 'e2e', tinyllama_config(LTINY), 64, 0, 8,
                         {'flash_prefill': (L1, 0), 'paged_decode': (0, L1)},
                         info['nvidia_smi'], combined={'paged_decode': 1},
                         graphs_check={})
    # exactly one int8 decode a layer per decode step, which splits every call at the
    # 17-page table (its combine counted apart), and the gd GEMM four times a layer per
    # decode step and per prefill step of at most 256 rows
    paths['e2e_w4a16_kv8'] = timed(
        'e2e_w4a16_kv8', e2e_phase, 'e2e_w4a16_kv8', llama7b_w4_config(LW4), 128, 4, 64,
        {'flash_prefill': (L7, 0), 'paged_decode_int8': (0, L7),
         'w4a16_gemm': (0, 4 * L7, 4 * L7)},
        info['nvidia_smi'], exact=True, combined={'paged_decode_int8': 1},
        graphs_check={})
    paths['e2e_gptoss_mxfp4'] = timed(
        'e2e_gptoss_mxfp4', e2e_phase, 'e2e_gptoss_mxfp4', gptoss_config(LGPT), 64, 0, 32,
        {'paged_decode': (0, LGPT), 'mxfp4_bmm': (0, 3 * LGPT)}, info['nvidia_smi'],
        combined={'paged_decode': 0.5})
    # Mixtral-8x7B W4A16 under each schedule, sharing one seeded tree: gd runs as the
    # other cells do, the other three schedules once with 16 tokens.  63 short prompts
    # and the long one fill the 64-row batch in one wave (a 65th request would wait for
    # the whole wave, and decode tok/s would then divide every token by the second
    # wave's time alone).  Each decode step
    # launches the schedule's kernel for wqkv and wo on every layer, and no other
    # W4A16 kernel
    LM = LMIX
    mixtral = {}
    for sched, env in W4_SCHEDULES.items():
        name = 'e2e_mixtral8x7b_w4a16' + ('' if sched == 'gd' else f'_{sched}')
        kernel = W4_KERNEL_OF[sched]
        gd = sched == 'gd'
        paths[name] = timed(
            name, e2e_phase, name, mixtral_config(LMIX), 64, 0, 63,
            {'flash_prefill': (LM, 0), 'paged_decode': (0, LM), kernel: (0, 2 * LM, 2 * LM)},
            info['nvidia_smi'], short_len=256, long_len=2048, exact=True, shared=mixtral,
            env=env, forbid=sorted(set(W4_KERNEL_OF.values()) - {kernel}),
            runs=2 if gd else 1, new_tokens=64 if gd else 16, trace=gd,
            combined={'paged_decode': 1})
    mixtral.clear()
    paths['e2e_deepseek_v2_lite_fp8'] = timed(
        'e2e_deepseek_v2_lite_fp8', deepseek_e2e_phase, info['nvidia_smi'])
    # the 8-bit formats and the MoE families: 63 short prompts and one long one (above
    # PhiMoE's 4096-token original context, so its long rope table is on the path), 32
    # greedy tokens each, two runs with launches exactly one flash_prefill a layer per
    # fresh prefill step and one paged_decode a layer per decode step, then traced, then
    # the greedy requests on an eager_mode engine of the same weights (tokens equal)
    for name, model, long_len in (
            [(f'e2e_{W8_PHASE[f]}', w8_config(f, L8), 2048) for f in W8_CONFIGS]
            + [(f'e2e_{m}', moe_config(m, LMOE), 4096 if m == 'phimoe' else 2048)
               for m in MOE_CONFIGS]):
        L = model.num_layers
        paths[name] = timed(name, e2e_phase, name, model, 64, 0, 63,
                            {'flash_prefill': (L, 0), 'paged_decode': (0, L)},
                            info['nvidia_smi'], short_len=256, long_len=long_len,
                            exact=True, new_tokens=32,
                            graphs_check=dict(traffic=('greedy',), trace=False))
    # the dense variants: the same traffic with the long prompt past Gemma-2's and
    # StarCoder2's window; their attention softcap or window sends every prefill chunk to
    # the gathered path (no flash_prefill), GLM-4's fresh chunks take flash_prefill
    for family in DENSE_CONFIGS:
        name, model = f'e2e_{family}', dense_config(family, LDENSE)
        L = model.num_layers
        flash = family == 'glm4_9b'
        need = dict({'flash_prefill': (L, 0)} if flash else {}, paged_decode=(0, L))
        paths[name] = timed(name, e2e_phase, name, model, 64, 0, 63, need,
                            info['nvidia_smi'], short_len=256, long_len=DENSE_LONG[family],
                            exact=True, new_tokens=32,
                            forbid=() if flash else ('flash_prefill',),
                            graphs_check=dict(traffic=('greedy',), trace=False))
    # speculative decoding over Llama-3.1-8B: EAGLE-3, a Llama-3.2-1B draft, a self-draft
    paths.update(timed('spec', spec_phase, info['nvidia_smi']))
    # MTP speculative decoding on DeepSeek-V3 and DeepSeek Sparse Attention (V3.2)
    paths.update(timed('mtp_dsa', mtp_dsa_phase, info['nvidia_smi']))
    # the hybrid gated-DeltaNet family: Qwen3-Next-80B-A3B (and Qwen3.5-MoE's layout)
    paths.update(timed('qwen3_next', qwen3_next_phase, info['nvidia_smi']))
    main_path = {'fp8_bmm': 'e2e_deepseek_v2_lite_fp8', 'flash_prefill': 'e2e',
                 'paged_decode': 'e2e', 'paged_decode_cp': 'e2e_llama31_8b_cp2',
                 'paged_decode_int8': 'e2e_w4a16_kv8', 'w4a16_gemm': 'e2e_w4a16_kv8',
                 'w4a16_szc': 'e2e_mixtral8x7b_w4a16_fast',
                 'w4a16_unprepared': 'e2e_mixtral8x7b_w4a16_unprepared',
                 'mxfp4_bmm': 'e2e_gptoss_mxfp4',
                 **{kernel: f'e2e_llama31_8b_{KV_PHASE[p]}' for p, kernel in KV_POLICIES.items()}}
    for k in kernels:
        name = k['name']
        k['launches_by_path'] = {p: row['launches'][name] for p, row in paths.items()}
        k['launches'] = paths[main_path[name]]['launches'][name]
        if name in paths[main_path[name]]['combines']:
            k['combine_launches'] = paths[main_path[name]]['combines'][name]
        rows = paths[main_path[name]]['rows_by_kernel'].get(name)
        if rows:
            k['launches_by_rows'] = rows
    emit({'phase': 'timing', 'seconds': seconds,
          'total_s': round(time.perf_counter() - t_start, 1)})
    emit({'kernels': kernels, 'main_path': main_path})
    print(info['nvidia_smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': info['kind'],
                                 'count': info['count']}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
