#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

  1. device   — the card's name, device count, nvidia-smi name and power limit;
  2. build    — one nvcc per kernel source, all started together: the
                delta-pipeline kernels (K1, K2, K3, K4), K5, K6 and K7
                (seconds, and the -Xptxas -v register / shared-memory
                report; the three instantiations of the streaming
                fedavg_kernel of K1, K3 and K4 on a line each, and no
                spills in any; the nine instantiations of K3's
                robust_kernel (N2 from 1 to 64 in registers, 128 and 256
                in shared memory), no spill in any and no stack in the
                register ones;
                K6's chunk size, window, grid and shared memory at the prefill's shape, and the registers and
                spills of each of its instantiations; the registers and
                spills of K5's and K7's hd-256 instantiations);
  3. kernels  — K1 (fedavg_apply) held against its plain version at the
                JAX package's FEDAVG_CASES shapes, the simulator's cohort
                (64, 112,766) in float32 and bf16 and kernels_bench's
                (32, 65,536), to the JAX tests' tolerances, and with no
                client selected; K2 (delta_sq_norms) and K3 (delta_pipeline_apply) held
                against their plain PyTorch versions on the card, at the
                slice's shape (C=64, P=112,766 in the MLP's six leaves) and a
                small ragged shape, over six gate sets (the median
                bitwise, torch.equal); K3's median / trimmed route
                (robust_kernel) at C = 16, 24, 64, 100 and 256 over a
                ragged P = 1,000 and at HAR's (64, 156,230), gates none /
                clip / int8 / top-k / clip+int8, on finite deltas and with
                one client's delta NaN and NaN entries in another's: the
                median bitwise equal to its plain version on the inputs
                the kernel reads (NaN where it has NaN), the trimmed mean
                to the gates' tolerance, and with no client selected +inf
                and the base exactly; K4
                (delta_pipeline_partial) likewise at (C_local, P) = (16,
                112,766), (64, 112,766) and a ragged (16, 1,000), gates none /
                clip (with K2) / int8 / top-k; the streaming fedavg_kernel
                with every gate off bit for bit equal (torch.equal) to its
                plain version for K3, K4 and K1 in float32 at EXACT_CASES
                (the slice, a fog's block at four fogs and at two, HAR's
                156,230 columns aligned and one element past and its fog
                block, contiguous views one or three elements past a
                16-byte boundary, P = 112,767, C = 1, C = 4,096 at P =
                130), K4 on all-zero weights equal to plain and to zero
                and K3 on an all-false mask equal to plain and to the
                base (ZERO_WEIGHT_CASES), and K1 in bf16 at D = 4,999 (aligned and
                misaligned) and at the cohort to the JAX tests' tolerance
                and equal to its own arithmetic (k1_exact);
                then K2, K3 and K4 timed at the
                main path's shapes beside the plain version, the byte bound
                and one PyTorch library call, K1 likewise at (64,
                112,766) and (32, 65,536) float32 and at (64, 112,766) in
                bf16 (beside torch.addmv in bf16), K3's median and
                trimmed-mean route once at the slice beside torch.median /
                torch.sort + slice + mean over the selected rows, K4 at
                two fogs' 32-row blocks beside torch.mv, and the streaming
                kernel's plan (blocks, columns per block, rows per stage,
                stages, bytes in flight per SM) printed at each timed
                shape; K5 (flash_attention_fwd) held
                against its plain version at the serving prefill's shape
                (B=1, H=32, Hkv=8, S=128, hd=64, bf16) and at edge shapes
                (window, bidirectional, GQA 8, 4 and 1, Sq < Sk, ragged and
                multi-tile S, every hd from 16 to 128, and hd 256 at
                gemma3-12b's 16 over 8 heads: S = 2,048 with the 1,024
                window and global, the 128-token prefill, bidirectional and
                float32; hymba-1.5b's group of 5, global and past its 1,024
                window; internvl2-2b's 136-row prompt at hd 128;
                seamless-m4t-medium's bidirectional encoder and cross-
                attention, Sq 128 and Sq 1 over 128 frames, at B 8) on
                both routes (bf16
                tensor cores, float32 CUDA cores), K7 (paged_attention_fwd)
                at the decode step's shape (8 slots of 129..160 tokens, page
                16) and at edge shapes (ragged and empty slots, windows,
                trash-page table entries, g 1, 2 and 8) and at its split
                plan's boundaries (one live token, fewer live pages than
                splits, windows that kill whole splits, 40 pages through
                the page ring; hd 256 at gemma3's g 2 over 130 pages with
                lengths past the 1,024 window, windowed and global, and at
                the decode step's shape; hymba's g 5 and internvl2's g 2
                at hd 128), the kernel's own empty slots exact zeros;
                then both timed at the slice's shapes beside the plain
                version, the bound and SDPA, with K7's split plan
                printed, at hd 256 (K5 at 2,048 tokens, K7 at 8 slots of
                1,025..2,080 keys, each windowed and global) and at the
                HYBRID, VLM and ENCDEC families' prefill, cross-attention
                and decode shapes (time_attention_families); K6
                (wkv6_fwd) held against its plain version at the rwkv6
                prefill's shape (B=1, T=128, H=32, K=V=64, bf16), at B=2
                with a ragged T=100, at T < 32, in float32, on strided views
                (float32 and bf16), with strong decay (ww in [-4, 3], float32 and bf16) and at a
                long T=2,048 (16 windows of the kernel's staging, the state
                carried from one to the next): y to one bf16 rounding
                (float32: 1e-5) and the float32 state to 1e-5 of its max,
                every value finite; then timed at the prefill's shape beside
                the plain version and the bound;
  4. slices   — the port's main paths through FedFogSimulator(...,
                device="cuda").run_scanned(), launch counts set to 0 just
                before each run and read just after:
                  dense: SimulatorConfig(rounds=20, use_pallas_agg=True); K3
                  once per round, every metric finite, round-0 cold starts
                  equal to the selected count, final accuracy >= 0.85; then 3
                  rounds each with the median and trimmed-mean aggregators;
                  population and fog: SimulatorConfig(population=1_000_000,
                  num_clients=64, fog_nodes=4, use_pallas_agg=True,
                  rounds=20); K4 launched 4 times per round and K2 / K3 never,
                  every metric finite, at most top-k = 24 selected per round,
                  final accuracy >= POP_FOG_MIN_ACCURACY; its init seconds at
                  M = 10^6, ms/round and peak bytes printed; then 3 rounds at
                  population 10^6 with one fog (K3 three times) and 3 dense
                  rounds with four fogs (K4 twelve times);
                  robustness, at the dense configuration (20 rounds unless
                  noted, K2 never launched): Table V's five attack settings
                  under FedAvg (K3 20 times each), noise and model
                  replacement under median and trimmed mean (K3 20 times
                  each, all on robust_kernel as K3's C entry counts it), final accuracies and the severity order
                  printed; HAR dense (K3 20 times, final accuracy > 0.3)
                  and 3 HAR rounds at population 10^6 with four fogs (K4 12
                  times); the fault runs of benchmarks/robustness_faults.py
                  (crash 0.2 and 0.5 with 2 retries, the storm as a barrier
                  and with a deadline and quorum: K3 20 times and retries
                  > 0; fog outages at two fogs (K4 40 times) and at
                  population + four fogs (K4 80 times), without failover
                  losing updates and with it losing none and rerouting some),
                  dispatched = completed + terminal + lost in every round;
                  3 rounds below quorum leaving the parameters bitwise
                  unchanged, every dispatching round skipped; the host
                  synchronisations of 3 dense rounds 1 (the final copy),
                  with and without faults and the noise attack and under
                  int8 and top-k compression, the population + fog count
                  printed beside; a 20-round run tapped
                  every 5 rounds, its rows equal to the history and its
                  history equal to the untapped run's; ms/round of each
                  run printed beside the card's name and power limit;
                async: the event engine (sim.events.AsyncFedFogSimulator)
                  at the dense width, 20 dispatches, use_pallas_agg: (a)
                  cohort mode, (b) FedAsync with a 0.5 straggler tail, (c)
                  FedBuff(8) at four fogs, (d) FedBuff(8) under median and
                  the noise attack, (e) FedBuff(8) with churn and faults
                  (crashes, retries, a deadline), (f) FedBuff(8) at
                  population 10^6 with four fogs; K3 launched once per
                  flush in (a), (b), (e) (on its staleness route),
                  robust_kernel once per flush in (d), K4 four times per
                  flush in (c), (f); no queue drop; admitted = completions
                  + terminal + lost + in flight, and without faults
                  completions = aggregated + buffered; (a) equal to the
                  port's run_scanned() (accuracy within 2/512, counts
                  exactly); staleness > 0 in (b); the coalesced loop equal
                  to the single-pop loop bit for bit on (b) and (e) at 5
                  dispatches; host synchronisations per coalesced step (at
                  most 2, and 1 for the check that finds the queue empty)
                  on (a), (b), (e); wall ms per dispatch and
                  per flush printed;
                sweep: run_sweep at the dense configuration, 10 rounds,
                  seeds 0-2, policy (4) x lr (2): K3 once per round, seed 1
                  of two points equal to its standalone run_scanned() bit
                  for bit, group=False equal to group=True, aot_scanned()
                  of one simulator run by run_scanned_with() on peers of
                  seeds 0 and 1 equal to their run_scanned(); an async
                  FedBuff(8) sweep of two seeds, K3 once per flush, seed 1
                  equal to the standalone engine's run; wall seconds per
                  (point, seed) printed;
                serving: ContinuousBatchingEngine for full-width llama3.2-1b
                in bf16 (random weights from a seed), attn_impl "flash" and
                attn "paged", 8 slots of 16-token pages, 128-token prompts,
                16 requests at 20 per virtual second generating 4..32
                tokens, after the dense-mode engine on the same trace: every
                request completed, slot conservation, tokens in [0, vocab),
                K5 16 launches per admission, K7 16 per decode step, K2-K4
                none; prefill tokens equal to the dense engine's; the first
                decode step's logits of 8 slots admitted afresh within
                LOGITS_RTOL of the dense mode with its attention in float32;
                the share of requests with the dense engine's tokens, wall
                ms per admission (8 admissions after one warm-up) and per
                decode step (10 steps), init s and peak bytes printed;
                rwkv6 serving: ContinuousBatchingEngine for full-width
                rwkv6-1.6b in bf16 (24 layers, d 2048, random weights from
                a seed) on the same kind of trace: every request completed,
                slot conservation, tokens in [0, vocab), K6 24 launches per
                admission, K1-K5 and K7 none; the prefill logits of the
                16 prompts through K6 against the same prefill on K6's
                plain version: in a float32 copy of the model within
                RWKV_F32_RTOL of max |logit|, and in bf16 no further from
                the float32 logits than RWKV_BF16_FACTOR times the plain
                bf16 prefill is (their share of max |logit| printed);
                every slot state finite after
                8 admissions and 20 decode steps; wall ms per admission and
                per decode step, tokens per wall second, init s, peak bytes
                and the share of first tokens equal to the plain prefill's
                printed;
                serving_moe: serving's engines and gates for
                moonshot-v1-16b-a3b at full width and depth (48 layers, 64
                experts top-6, 28.06e9 parameters) in bf16, K5 48 launches
                per admission and K7 48 per decode step; on layer 24's own
                input from a real prefill the served dropless MoE FFN
                within MOE_F32_RTOL of the all-experts oracle in float32
                and, in bf16, no further than the plain bf16 oracle from
                the float32 result; one decode step's MoE FFN under
                set_sync_debug_mode("error"); the served FFN's and the
                oracle's device ms on the prefill and decode inputs, init s,
                parameter and active counts, peak bytes, wall ms per
                admission and decode step, tokens per wall second,
                launches per decode step (profiler), the host
                synchronisations of a whole decode step and the distinct
                experts each layer of a decode step hits printed;
                serving_archs: qwen2.5-14b, yi-9b and gemma3-12b at full
                width and depth, then mixtral-8x7b at full width with 8 of
                its 32 layers, one at a time: 8 admissions (K5 = layers x
                8), then the first decode step of the 8 slots paged (K7 =
                layers) within LOGITS_RTOL of the dense mode with its
                attention in float32; wall ms per admission and decode
                step and peak bytes printed;
                serving_families: hymba-1.5b (HYBRID) and internvl2-2b
                (VLM, 8 patch embeddings prepended) at full width and
                depth through serving's engines and gates (K5 = layers x
                admissions, K7 = layers x decode steps, the paged first
                step within LOGITS_RTOL of the dense mode with float32
                attention over the true vocab); hymba's slot SSM and conv
                states after an admission within SSM_STATE_RTOL of each
                layer's SSM branch in float32, and the plain selective
                scan timed; device ms, busy share and launches of a
                decode step (profiler) printed;
                serving_encdec: seamless-m4t-medium at full width and
                depth through launch/serve.py's static engine with
                --flash (batch 8, 128 frames and tokens, 32 generated):
                K5 = 36 a prefill + 12 a decode step and nothing else; the
                prefill's and first decode step's logits within
                LOGITS_RTOL of the same model on float32 plain attention;
                wall and device ms per prefill and decode step printed;
                async_cli: the async engine's CLI smoke
                (sim.events.engine._smoke, FedBuff(4), 16 clients, a
                2,000 ms horizon) on the card, flushes > 0;
                train: launch/train.py's loop (fl.round) on full-width
                llama3.2-1b in bf16 (16 layers, d 2048, P = 1,235,814,400,
                random weights from a seed), 32 clients, 4 slots, 2 local
                steps of 4 x 128 tokens: (a) --pallas-agg, 3 rounds, K3
                once a round on its momentum route, round 3's K3 outputs
                held against the plain version window by window over the
                whole (4, P) buffer (4.94e9 elements, past 2^32) to the
                momentum gates' tolerance, 0 host synchronisations inside
                each round, every loss finite, K3 / K4 / K2 timed at this
                shape beside their byte bounds; (c) one round with clip
                1.0, int8 and DP noise: K2 and K3 once, K2's norms of the
                round's buffer within 1e-5 of the plain version's; (b)
                --fog-nodes 2 --population 1000000, 3 rounds: K4 twice a
                round, each fog's partial of round 3 bit for bit its plain
                version (also on nonzero weights); (d) --scale tiny: a
                checkpoint saved and restored, its next round bit for bit
                the uninterrupted one's; ms per round, tokens per wall
                second, the model FLOP share and peak bytes printed beside
                the card's name and power limit;
                dist: the client-sharded LM round (python -m
                repro_torch.dist.selftest, a child process: its ranks
                start by spawn) on full-width llama3.2-1b in bf16, 2 ranks
                of one slot each sharing the card through gloo (its
                all-reduce stages CUDA tensors through host memory; NCCL
                needs a card per rank), --pallas-agg, a round of gates
                legacy and one of full (clip, int8, DP), (a) flat and (b)
                with the pod axis as a two-node fog tier: K4 once per
                rank per round, K2 once per rank in the full round, K3
                never; one all-reduce of the (P+2,) float32 pack a round,
                the contract asserted on every rank; every rank's state
                equal; rank 0's parameters within one bf16 ulp and its
                momentum within 2^-20 of each leaf's max of the
                single-process round with C = 2 on the same inputs (run
                by the child after its ranks exit, from rank 0's state
                before each round), held on fingerprints (per leaf the
                float64 sum, sum of squares and 4,096 seeded
                coordinates); per-rank peak bytes, round and all-reduce
                wall ms printed; then K4 alone at a rank's (1, P) bit for
                bit its plain version, timed beside it, torch.mv,
                torch.mul (at one row the same sum) and the byte bound;
                tp: the tensor axes (python -m repro_torch.dist.selftest
                --model-split, a child process), 2 ranks sharing the
                card through gloo: (a) full-width llama3.2-1b in bf16,
                (client 1, tp 2), one slot, 2 local steps of 4 x 128
                tokens, --pallas-agg, gates legacy, legacy, full: each
                rank holds its blocks of the parameters and momentum,
                the server pass gathers whole rows over tp and runs K3
                (the client axes span one rank) once per rank per round,
                K2 once per rank in the full round, K4 never; no delta
                all-reduce; every rank's gathered state equal; rank 0's
                gathered parameters and momentum held against the
                single-process round (the selftest's bf16 tensor-axis
                bounds); (b) qwen2.5-14b at full width in bf16 (40 heads,
                8 kv heads, head_dim 128, qkv bias, untied), (tp 1, sp
                2), cut to TP_QWEN_LAYERS of its 48 layers: the loss and
                gradient of one local step held against the
                single-process step (STEP_TOL); per rank its peak bytes,
                round or step ms, the tensor-axis collectives per local
                step (count, bytes, wall ms), the server pass's gathers,
                the delta all-reduces per round and the K2 / K3 / K4
                launches printed; then K3 alone at a rank's (1, P) on its
                momentum route, held against its plain version window by
                window and timed beside it, torch.addmv and the byte
                bound;
                serve_dist: serving under mesh rules (python -m
                repro_torch.dist.selftest --mode serve, a child process
                each), 2 ranks sharing the card through gloo, 128-token
                prompts, 16 tokens a request, --flash: (a) full-width
                llama3.2-1b in bf16 over tp 2 (each rank its blocks and
                kv heads): the static engine on a batch of 8, then the
                continuous engine, 16 requests on 8 slots, --attn paged;
                (b) llama3.2-1b on the scaled plan of 2 devices, static:
                a batch of 8 batch-parallel (4 rows a rank) and a batch
                of 1 sequence-parallel (64 prompt positions a rank); (c)
                qwen2.5-14b at full width (qkv bias, 40 heads over 8 kv
                heads, head_dim 128) cut to SERVE_DIST_QWEN_LAYERS of its
                48 layers, (tp 1, sp 2), both engines: every request
                completed, every rank's tokens the same, the decode
                census equal to the layout's count, K5 = layers per
                prefill or admission and K7 = layers per decode step on
                every rank, rank 0's first decode step's logits (the
                static batch's; the continuous engine's own, of its
                live slots) within LOGITS_RTOL of the single-process
                engine with its attention in float32 through the plain
                versions (no K5, no K7) and, under a model split, no
                further from the float32 run than BF16_TP_FACTOR times
                the single-process bf16 run (the child's check after its
                ranks exit); the requests agreeing with the
                single-process tokens, wall ms per prefill / admission
                and decode step, the census and peak bytes per rank
                printed; then K5 and K7 at a rank's heads held against
                their plain versions (ATTN_TOL) and timed beside them,
                the bound and SDPA;
  5. result   — the kernels' JSON line (K3 and K4 with their async and
                sweep launches beside the main paths', K2-K4 with the
                train, dist and tp phases' launches and times, K4's
                dist_* times at (1, P), K3's tp_* times at (1, P), K5's
                and K7's serve_dist launches and rank_heads times),
                nvidia-smi's line and, last, {"ok": true, "device":
                {...}}.

Each phase prints its seconds (``[phase] name=... seconds=...``).

Imports nothing of JAX or of the JAX package. Without a CUDA device, or
run from a directory without ``src/repro_torch``, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet, at the 700 W power limit: HBM rate, and float32
# outside the tensor cores (both kernels do float32 FMAs on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# 32-bit min / max instructions: 64 a clock per SM against the 128 FMAs (256
# FLOP) behind FP32_FLOP_PER_S (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0).
MINMAX_PER_S = FP32_FLOP_PER_S / 4
BF16_FLOP_PER_S = 989e12  # dense tensor-core rate; K5/K7 inputs are bf16
# Six leaves of the 784-128-64-62 MLP in fused order ([b, w] per layer).
SLICE_SEGS = (128, 784 * 128, 64, 128 * 64, 62, 64 * 62)
RAGGED_SEGS = (41, 8, 64, 17)
K4_RAGGED_SEGS = (300, 37, 600, 63)  # P = 1,000
# Accuracy floor of the population-and-fog run: the JAX package's own
# final accuracy at this configuration on the CPU, less 0.05, once that
# run (a million-client registry on a CPU) has been made; until then 0.80.
POP_FOG_MIN_ACCURACY = 0.80
POP_FOG = dict(population=1_000_000, num_clients=64, fog_nodes=4)


def kernel_counters():
    """{kernel: the wrapper whose ``launches`` attribute counts its
    launches}, K1 to K7."""
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu
    from repro_torch.kernels.fedavg.fedavg import launch_fedavg
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_cuda
    from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda

    return {"fedavg_apply": launch_fedavg, "delta_sq_norms": cu.delta_sq_norms_cuda,
            "delta_pipeline_apply": cu.launch_pipeline,
            "delta_pipeline_partial": cu.launch_partial,
            "flash_attention_fwd": flash_attention_cuda, "wkv6_fwd": wkv6_cuda,
            "paged_attention_fwd": paged_attention_cuda}


def zero_counts() -> None:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    counters["delta_pipeline_apply"].robust_launches = 0


def read_counts() -> dict:
    """{kernel: launches}, K1 to K7, and ``robust_kernel``: the K3
    launches that K3's C entry sent to its median / trimmed route."""
    counters = kernel_counters()
    counts = {name: fn.launches for name, fn in counters.items()}
    counts["robust_kernel"] = counters["delta_pipeline_apply"].robust_launches
    return counts


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n_iter: int, n_warm: int = 5) -> float:
    """Mean device milliseconds per call from CUDA events around ``n_iter``
    calls. A spin kernel queued first keeps the device busy while the host
    enqueues the calls, so host overhead per call does not leave the device
    idle inside the timed span (without it a 20 us kernel behind ~20 us of
    Python per call reads as the host's rate)."""
    import torch

    for i in range(n_warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)  # ~0.2 s of device cycles, before `start`
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def make_inputs(torch, c, segs, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = sum(segs)
    f = dict(generator=g, device=device)
    return dict(
        upd=torch.randn((c, p), **f) * 0.05,
        base=torch.randn((p,), **f),
        mask=torch.rand((c,), **f) < 0.7,
        weights=torch.rand((c,), **f) * 300 + 10,
        noise=0.01 * torch.randn((p,), **f),
        mu=torch.randn((p,), **f) * 0.01,
        staleness=torch.arange(c, device=device, dtype=torch.float32) % 4,
    )


# (name, kwargs builder). Each output is held to ATOL + RTOL·|r − i|, where
# r is the plain version's output and i the input it updates (base or μ):
# the tolerance scales with the kernel's own step lr·agg (~5e-3 here), not
# with the ~1-sized base it is added to. ATOL covers one rounding of the
# output at |base| < 8 (one ulp there is 4.8e-7).
GATES = [
    ("fedavg", lambda fx, segs: {}),
    ("fedavg+dp", lambda fx, segs: dict(dp_noise=fx["noise"])),
    ("median", lambda fx, segs: dict(aggregator="median")),
    ("trimmed", lambda fx, segs: dict(aggregator="trimmed", trim_fraction=0.1)),
    ("fedavg+clip+int8+staleness+fedavgm", lambda fx, segs: dict(
        clip_norm=1.5, compression="int8", seg_sizes=segs,
        staleness=fx["staleness"], staleness_exponent=0.5, momentum=fx["mu"],
        server_optimizer="fedavgm")),
    ("fedavg+clip+topk+fedadam", lambda fx, segs: dict(
        clip_norm=1.5, compression="topk", topk_fraction=0.1, seg_sizes=segs,
        momentum=fx["mu"], server_optimizer="fedadam")),
]
ATOL, RTOL = 1e-6, 1e-5


def check_partial(torch, dp, dev):
    """K4 against its plain version over the gates, at a fog's block of the
    main path (16 clients), the whole cohort (64) and a ragged (16, 1,000).
    K4's sum is unnormalized (weights mask·|D| of ~10²); the cloud divides
    it by Σdm, after which it is held to K3's tolerance with the partial as
    the step: |o − r| ≤ (ATOL + RTOL·|r|/Σdm)·Σdm. Returns the max abs error
    of the unnormalized outputs."""
    worst = 0.0
    for shape_name, c, segs in (("fog", 16, SLICE_SEGS), ("cohort", 64, SLICE_SEGS),
                                ("ragged", 16, K4_RAGGED_SEGS)):
        fx = make_inputs(torch, c, segs, 4321, dev)
        dm = fx["mask"].float() * fx["weights"]
        scale = float(dm.sum())
        for name, kw in (
            ("none", {}),
            ("clip", dict(clip_norm=1.5)),
            ("int8", dict(compression="int8", seg_sizes=segs)),
            ("topk", dict(compression="topk", topk_fraction=0.1, seg_sizes=segs)),
            ("clip+int8", dict(clip_norm=1.5, compression="int8", seg_sizes=segs)),
        ):
            out = dp.delta_pipeline_partial(fx["upd"], dm, **kw)
            ref = dp.delta_pipeline_partial_ref(fx["upd"], dm, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"partial {name}: non-finite output")
            err = float((out - ref).abs().max())
            bad = (out - ref).abs() > (ATOL + RTOL * ref.abs() / scale) * scale
            say("kernels", kernel="delta_pipeline_partial", shape=shape_name,
                gates=name, C_local=c, P=sum(segs), max_abs_err=err,
                sum_dm=scale, atol=f"{ATOL} of sum_dm", rtol=f"{RTOL} of |partial|")
            check(not bool(bad.any()),
                  f"delta_pipeline_partial {name} {shape_name}: max_abs_err {err}")
            worst = max(worst, err)
    return worst


# K1 cases (N, D, dtype): the JAX package's FEDAVG_CASES shapes
# (tests/test_kernels.py), the simulator's cohort and kernels_bench's.
K1_CASES = [(8, 1000, "float32"), (16, 4096, "float32"), (32, 5000, "bfloat16"),
            (64, 333, "float32"), (4, 2048, "float32"), (64, 112_766, "float32"),
            (64, 112_766, "bfloat16"), (32, 65_536, "float32")]
# The JAX tests' absolute tolerances (tests/test_kernels.py:137): float32
# 2e-6 (summation order around |base| ~ 1); bf16 5e-2 (one rounding of
# the output at |x| < 8 is at most 2^-5).
K1_ATOL = {"float32": 2e-6, "bfloat16": 5e-2}


def check_fedavg(torch, fa, dev):
    """K1 against its plain version on the JAX tests' kind of inputs
    (N(0, 1) updates and base, 70 % of clients selected, weights
    |N(0, 1)|·100, lr 0.9); then with no client selected, where the base
    must come back. Returns the max abs error."""
    worst = 0.0
    for i, (n, d, dtype) in enumerate(K1_CASES):
        g = torch.Generator(device=dev)
        g.manual_seed(500 + i)
        dt = getattr(torch, dtype)
        upd = torch.randn((n, d), generator=g, device=dev).to(dt)
        base = torch.randn((d,), generator=g, device=dev).to(dt)
        mask = torch.rand((n,), generator=g, device=dev) < 0.7
        w = torch.randn((n,), generator=g, device=dev).abs() * 100
        out = fa.fedavg_apply(upd, base, mask, w, lr=0.9)
        ref = fa.fedavg_apply_ref(upd, base, mask, w, lr=0.9)
        torch.cuda.synchronize()
        check(out.dtype == base.dtype and out.shape == base.shape, f"fedavg {n}x{d}: {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"fedavg {n}x{d} {dtype}: non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        say("kernels", kernel="fedavg_apply", N=n, D=d, dtype=dtype, max_abs_err=err,
            atol=K1_ATOL[dtype])
        check(err <= K1_ATOL[dtype], f"fedavg_apply {n}x{d} {dtype}: max_abs_err {err}")
        worst = max(worst, err)
        if i == 0:
            none = fa.fedavg_apply(upd, base, torch.zeros_like(mask), w)
            check(torch.equal(none, base), "fedavg_apply with no client selected")
            say("kernels", kernel="fedavg_apply", N=n, D=d, case="no client selected",
                equal_to_base=True)
    return worst


# The streaming fedavg_kernel (K3's weighted sum, K4, K1) with every gate
# off equals its plain version bit for bit: clients in order, one FMA each
# (ref.py's _fma rounds once), one rounding of the apply. (name, C, P,
# elements from a 16-byte boundary to the buffer's first element): the
# slice, a fog's block at four fogs and at two, HAR's cohort (156,230
# columns, a row 8 mod 16 bytes long) aligned and one element past, HAR's
# fog block, a contiguous view one element past a boundary (so every row
# and both ends of the tensor are misaligned), a ragged P, one client,
# and 4,096 clients at a small P.
EXACT_CASES = [
    ("slice", 64, 112_766, 0),
    ("fog block", 16, 112_766, 0),
    ("fog block, two fogs", 32, 112_766, 0),
    ("HAR", 64, 156_230, 0),
    ("HAR, view +1", 64, 156_230, 1),
    ("HAR fog block", 16, 156_230, 0),
    ("view one element past 16 bytes", 64, 112_766, 1),
    ("P 112,767", 64, 112_767, 0),
    ("P 112,767, view +3", 16, 112_767, 3),
    ("C 1", 1, 112_766, 0),
    ("C 4,096, P 130", 4096, 130, 0),
    ("C 4,096, P 130, view +1", 4096, 130, 1),
]
# K1 in bf16 (N, D, offset): an odd D, so each row starts 2 bytes further
# from a boundary than the one before, aligned and one element past.
K1_BF16_CASES = [(64, 4_999, 0), (64, 4_999, 1), (64, 112_766, 0)]


def offset_view(torch, c, p, offset, dtype, gen, dev, scale=1.0):
    """A contiguous (c, p) view whose first element lies ``offset``
    elements past the start of its (256-byte-aligned) allocation."""
    flat = (scale * torch.randn((c * p + offset,), generator=gen, device=dev)).to(dtype)
    x = flat[offset:].view(c, p)
    check(x.is_contiguous() and x.data_ptr() - flat.data_ptr() == offset * x.element_size(),
          "offset view")
    return x


def k1_exact(torch, dp, fa_cuda, upd, base, mask, w, lr):
    """K1's function in its own arithmetic: Σ over clients in order of
    one FMA each with the wrapper's weight row, then base + sum rounded
    once to float32 and once to the dtype."""
    agg = dp.delta_pipeline_partial_ref(upd.float(), fa_cuda.weight_row(mask, w, lr))
    return (agg + base.float()).to(base.dtype)


def check_streaming_exact(torch, dp, fa, dev):
    """The torch.equal checks of K3 (fedavg gate set), K4 (no gate) and K1
    (float32) at EXACT_CASES; K1 in bf16 at K1_BF16_CASES to the JAX
    tests' tolerance against its plain version and equal to k1_exact."""
    from repro_torch.kernels.fedavg import fedavg as fa_cuda

    gen = torch.Generator(device=dev)
    for i, (name, c, p, offset) in enumerate(EXACT_CASES):
        gen.manual_seed(900 + i)
        upd = offset_view(torch, c, p, offset, torch.float32, gen, dev, scale=0.05)
        base = torch.randn((p,), generator=gen, device=dev)
        mask = torch.rand((c,), generator=gen, device=dev) < 0.7
        mask[0] = True
        w = torch.rand((c,), generator=gen, device=dev) * 300 + 10
        dm = mask.float() * w
        k3 = dp.delta_pipeline_apply(upd, base, mask, w, lr=0.7)
        k4 = dp.delta_pipeline_partial(upd, dm)
        k1 = fa.fedavg_apply(upd, base, mask, w, lr=0.9)
        eq = {"k3": torch.equal(k3, dp.delta_pipeline_ref(upd, base, mask, w, lr=0.7)),
              "k4": torch.equal(k4, dp.delta_pipeline_partial_ref(upd, dm)),
              "k1": torch.equal(k1, k1_exact(torch, dp, fa_cuda, upd, base, mask, w, 0.9))}
        say("kernels", kernel="fedavg_kernel", case=repr(name), C=c, P=p,
            offset_bytes=upd.data_ptr() % 16, **{f"{k}_equal": v for k, v in eq.items()})
        for k, v in eq.items():
            check(v, f"{k} not bitwise equal to its plain version at {name}")
    check_zero_weight(torch, dp, gen, dev)
    for i, (n, d, offset) in enumerate(K1_BF16_CASES):
        gen.manual_seed(950 + i)
        upd = offset_view(torch, n, d, offset, torch.bfloat16, gen, dev)
        base = torch.randn((d,), generator=gen, device=dev).to(torch.bfloat16)
        mask = torch.rand((n,), generator=gen, device=dev) < 0.7
        w = torch.randn((n,), generator=gen, device=dev).abs() * 100
        out = fa.fedavg_apply(upd, base, mask, w, lr=0.9)
        ref = fa.fedavg_apply_ref(upd, base, mask, w, lr=0.9)
        err = float((out.float() - ref.float()).abs().max())
        same = torch.equal(out, k1_exact(torch, dp, fa_cuda, upd, base, mask, w, 0.9))
        say("kernels", kernel="fedavg_apply", dtype="bfloat16", N=n, D=d,
            offset_bytes=upd.data_ptr() % 16, max_abs_err=err, atol=K1_ATOL["bfloat16"],
            equal_to_own_arithmetic=same)
        check(out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all()),
              f"fedavg_apply bf16 {n}x{d}+{offset}")
        check(err <= K1_ATOL["bfloat16"], f"fedavg_apply bf16 {n}x{d}+{offset}: {err}")
        check(same, f"fedavg_apply bf16 {n}x{d}+{offset}: not its own arithmetic")


# Blocks that sum zero weight on the robustness path: a dark fog's K4
# block (C_local, P) with every weight 0, and K3 on a skipped round's
# all-false mask (C, P). (name, C, P, elements past a 16-byte boundary.)
ZERO_WEIGHT_CASES = [
    ("dark fog, four fogs", 16, 112_766, 0),
    ("dark fog, two fogs", 32, 112_766, 0),
    ("dark fog, HAR", 16, 156_230, 0),
    ("skipped round", 64, 112_766, 0),
    ("skipped round, HAR, view +1", 64, 156_230, 1),
]


def check_zero_weight(torch, dp, gen, dev):
    """K4 on an all-zero weight block equals its plain version and is
    zero; K3 on an all-false mask equals its plain version and the base."""
    for i, (name, c, p, offset) in enumerate(ZERO_WEIGHT_CASES):
        gen.manual_seed(970 + i)
        upd = offset_view(torch, c, p, offset, torch.float32, gen, dev, scale=0.05)
        base = torch.randn((p,), generator=gen, device=dev)
        w = torch.rand((c,), generator=gen, device=dev) * 300 + 10
        mask = torch.zeros((c,), dtype=torch.bool, device=dev)
        dm = mask.float() * w
        k4 = dp.delta_pipeline_partial(upd, dm)
        k3 = dp.delta_pipeline_apply(upd, base, mask, w, lr=0.7)
        eq = {"k4": torch.equal(k4, dp.delta_pipeline_partial_ref(upd, dm)),
              "k4_zero": torch.equal(k4, torch.zeros_like(k4)),
              "k3": torch.equal(k3, dp.delta_pipeline_ref(upd, base, mask, w, lr=0.7)),
              "k3_base": torch.equal(k3, base)}
        say("kernels", kernel="fedavg_kernel", case=repr(name), C=c, P=p, weight=0,
            offset_bytes=upd.data_ptr() % 16, **{f"{k}_equal": v for k, v in eq.items()})
        for k, v in eq.items():
            check(v, f"{k} check failed on zero weight at {name}")


def fedavg_plan_line(torch, dp, name, c, p, dtype):
    """Print the streaming kernel's plan at a main-path shape: blocks (one
    per SM), columns per block, tile, rows per stage, stages, shared bytes,
    and the bytes a block has requested once its ring is first filled."""
    cu = dp.delta_pipeline
    eb = torch.empty((), dtype=dtype).element_size()
    n_sms = cu.sm_count(torch.cuda.current_device())
    pl = cu.fedavg_plan(c, p, eb, n_sms)
    tiles = -(-pl.cols_per_block // pl.tile_cols)
    first_fill = min(pl.stages * pl.rows_per_stage, c * tiles) * pl.tile_cols * eb
    say("plan", kernel=name, C=c, P=p, dtype=str(dtype).split(".")[-1], sms=n_sms,
        blocks=pl.blocks, cols_per_block=pl.cols_per_block, tile_cols=pl.tile_cols,
        rows_per_stage=pl.rows_per_stage, stages=pl.stages, smem_bytes=pl.smem_bytes,
        ring_bytes=pl.ring_bytes, bytes_in_flight_per_sm=first_fill)


def ptxas_entries(log_text: str, kernel: str) -> list[dict]:
    """The instantiations of ``kernel`` in an `-Xptxas -v` report: mangled
    name, registers, static shared memory, stack, spill stores and loads."""
    import re

    out, cur = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            cur = None
            if kernel in ln:
                cur = {"mangled": ln.split("'")[1]}
                out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def fedavg_ptxas(log_text: str) -> list[dict]:
    """fedavg_kernel's instantiations in an `-Xptxas -v` report: name,
    registers, stack, spill stores and loads."""
    out = []
    for entry in ptxas_entries(log_text, "fedavg_kernel"):
        mangled = entry.pop("mangled")
        kind = ("<true, float> (K4)" if "ILb1E" in mangled else
                "<false, bf16> (K1)" if "bfloat16" in mangled else
                "<false, float> (K3, K1)")
        out.append({"kernel": f"fedavg_kernel{kind}", **entry})
    return out


def robust_ptxas(log_text: str) -> list[dict]:
    """robust_kernel's instantiations in an `-Xptxas -v` report: N2 (the
    column's padded length), where the column lives, registers, stack and
    spills."""
    import re

    out = []
    for entry in ptxas_entries(log_text, "robust_kernel"):
        m = re.search(r"robust_kernelILi(\d+)ELb([01])E", entry.pop("mangled"))
        out.append({"kernel": "robust_kernel", "N2": int(m.group(1)),
                    "column": "shared" if m.group(2) == "1" else "registers", **entry})
    return sorted(out, key=lambda e: e["N2"])


# K3's robust route (robust_kernel): (name, C, segs) at a ragged P = 1,000
# for every padded length from 16 to 256 (the shared-memory variant at C =
# 100 and 256) and at HAR's (64, 156,230).
HAR_SEGS = (128, 1152 * 128, 64, 128 * 64, 6, 64 * 6)
# Compare-exchanges of robust_kernel's network (Batcher's odd-even merge
# sort) over the 64 rows of the main paths' columns.
ROBUST_NETWORK_PAIRS_64 = 543
ROBUST_CASES = [(f"C {c}, P 1,000", c, K4_RAGGED_SEGS) for c in (16, 24, 64, 100, 256)]
ROBUST_CASES.append(("HAR", 64, HAR_SEGS))
ROBUST_GATES = [
    ("none", lambda segs: {}),
    ("clip", lambda segs: dict(clip_norm=1.5)),
    ("int8", lambda segs: dict(compression="int8", seg_sizes=segs)),
    ("topk", lambda segs: dict(compression="topk", topk_fraction=0.1, seg_sizes=segs)),
    ("clip+int8", lambda segs: dict(clip_norm=1.5, compression="int8", seg_sizes=segs)),
]


def robust_plain(torch, dp, upd, base, mask, w, kw):
    """The plain version of K3 on the inputs the kernel reads: with the clip
    gate on, the deltas pre-scaled by the wrapper's clip scales (K2's
    norms, which sum in another order than the plain version's), after
    which the plain version's compression table equals the kernel's."""
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    if kw.get("clip_norm", 0.0) > 0:
        pre = cu.gate_rows(upd, kw["clip_norm"], "none", 0.05, None)[0]
        upd, kw = upd * pre[:, None], dict(kw, clip_norm=0.0)
    return dp.delta_pipeline_ref(upd, base, mask, w, lr=0.7, **kw)


def same_or_both_nan(torch, a, b) -> bool:
    """Equal values (-0.0 == +0.0, as torch.equal) and NaN where the other
    has NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def nan_variant(torch, fx, c):
    """``fx``'s deltas with client c // 2 selected and its whole delta NaN,
    and every seventh entry of the next client's delta NaN."""
    upd, mask = fx["upd"].clone(), fx["mask"].clone()
    upd[c // 2] = float("nan")
    upd[(c // 2 + 1) % c, ::7] = float("nan")
    mask[c // 2] = True
    return upd, mask


def check_robust(torch, dp, dev) -> float:
    """K3's median / trimmed route against its plain version at
    ROBUST_CASES over ROBUST_GATES, on finite deltas and on deltas with NaN
    (``nan_variant``: the network keeps every value and sorts NaN after
    +inf, as the plain version's torch.sort does): the median bitwise
    (torch.equal, so -0.0 == +0.0; NaN where the plain version has NaN),
    the trimmed mean (trim 0.1, summed in another order) to ATOL +
    RTOL·|step| where the plain version is finite and equal elsewhere; with
    no client selected the median +inf and the trimmed mean the base,
    exactly. Returns the trimmed route's max abs error."""
    worst = 0.0
    for i, (name, c, segs) in enumerate(ROBUST_CASES):
        fx = make_inputs(torch, c, segs, 1500 + i, dev)
        variants = (("finite", fx["upd"], fx["mask"]), ("nan", *nan_variant(torch, fx, c)))
        for (vname, upd, mask), (gname, build) in itertools.product(variants, ROBUST_GATES):
            kw = build(segs)
            args = (upd, fx["base"], mask, fx["weights"])
            med = dp.delta_pipeline_apply(*args, lr=0.7, aggregator="median", **kw)
            med_ref = robust_plain(torch, dp, *args, dict(kw, aggregator="median"))
            tri = dp.delta_pipeline_apply(*args, lr=0.7, aggregator="trimmed",
                                          trim_fraction=0.1, **kw)
            tri_ref = robust_plain(torch, dp, *args, dict(kw, aggregator="trimmed",
                                                          trim_fraction=0.1))
            torch.cuda.synchronize()
            if vname == "finite":
                check(bool(torch.isfinite(med).all() and torch.isfinite(tri).all()),
                      f"robust {name} {gname}: non-finite output")
                equal = torch.equal(med, med_ref)
            else:
                equal = same_or_both_nan(torch, med, med_ref)
            fin = torch.isfinite(tri_ref)
            d = (tri - tri_ref)[fin].abs()
            err = float(d.max()) if d.numel() else 0.0
            bad = ((tri - tri_ref).abs() > ATOL + RTOL * (tri_ref - fx["base"]).abs())[fin]
            rest = same_or_both_nan(torch, tri[~fin], tri_ref[~fin])
            say("kernels", kernel="delta_pipeline_apply", route="robust_kernel",
                case=repr(name), deltas=vname, gates=gname, C=c, P=sum(segs),
                median_equal=equal, trimmed_max_abs_err=err, atol=ATOL,
                rtol=f"{RTOL} of |step|", nonfinite_plain=int((~fin).sum()),
                nonfinite_equal=rest)
            check(equal, f"robust median {name} {vname} {gname}: not its plain version")
            check(not bool(bad.any()) and rest,
                  f"robust trimmed {name} {vname} {gname}: max_abs_err {err}, "
                  f"non-finite equal {rest}")
            worst = max(worst, err)
        none = torch.zeros_like(fx["mask"])
        med = dp.delta_pipeline_apply(fx["upd"], fx["base"], none, fx["weights"], lr=0.7,
                                      aggregator="median")
        tri = dp.delta_pipeline_apply(fx["upd"], fx["base"], none, fx["weights"], lr=0.7,
                                      aggregator="trimmed")
        inf = bool((torch.isinf(med) & (med > 0)).all())
        same = torch.equal(tri, fx["base"])
        say("kernels", kernel="delta_pipeline_apply", route="robust_kernel",
            case=repr(name), gates="no client selected", median_all_pos_inf=inf,
            trimmed_equal_to_base=same)
        check(inf and same, f"robust {name}: no client selected")
    return worst


def phase_kernels(torch, dp):
    """Phase 3: kernel vs plain version, then timing. Returns per-kernel
    dicts for the JSON line (launches filled in by the slice phase)."""
    from repro_torch.kernels import fedavg as fa

    dev = torch.device("cuda")
    errs = {"delta_sq_norms": 0.0, "delta_pipeline_apply": 0.0,
            "fedavg_apply": check_fedavg(torch, fa, dev)}
    for shape_name, c, segs in (("slice", 64, SLICE_SEGS), ("ragged", 6, RAGGED_SEGS)):
        fx = make_inputs(torch, c, segs, 1234, dev)
        k2 = dp.delta_sq_norms(fx["upd"])
        r2 = dp.delta_sq_norms_ref(fx["upd"])
        torch.cuda.synchronize()
        e2 = float((k2 - r2).abs().max())
        tol2 = 1e-5 * float(r2.abs().max())
        say("kernels", kernel="delta_sq_norms", shape=shape_name, C=c, P=sum(segs),
            max_abs_err=e2, tol=tol2)
        check(e2 <= tol2, f"delta_sq_norms {shape_name}: {e2} > {tol2}")
        errs["delta_sq_norms"] = max(errs["delta_sq_norms"], e2)
        for name, build in GATES:
            kw = build(fx, segs)
            args = (fx["upd"], fx["base"], fx["mask"], fx["weights"])
            out = dp.delta_pipeline_apply(*args, lr=0.7, **kw)
            ref = dp.delta_pipeline_ref(*args, lr=0.7, **kw)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            ins = (fx["base"], fx["mu"])
            err = step = 0.0
            for o, r, i in zip(outs, refs, ins):
                check(bool(torch.isfinite(o).all()), f"{name}: non-finite output")
                err = max(err, float((o - r).abs().max()))
                step = max(step, float((r - i).abs().max()))
                bad = (o - r).abs() > ATOL + RTOL * (r - i).abs()
                check(not bool(bad.any()),
                      f"delta_pipeline_apply {name} {shape_name}: max_abs_err {err}")
            if name == "median":  # the sorted values are the plain version's
                check(torch.equal(out, ref), f"median {shape_name}: not its plain version")
            say("kernels", kernel="delta_pipeline_apply", shape=shape_name, gates=name,
                C=c, P=sum(segs), max_abs_err=err, max_abs_step=step, atol=ATOL,
                rtol=f"{RTOL} of |step|", **({"equal": True} if name == "median" else {}))
            errs["delta_pipeline_apply"] = max(errs["delta_pipeline_apply"], err)
        # No client selected: the reference's index arithmetic gives a +inf
        # median and the unchanged base for the trimmed mean; both must
        # match it exactly (inf included).
        none = torch.zeros_like(fx["mask"])
        for agg in ("median", "trimmed"):
            args = (fx["upd"], fx["base"], none, fx["weights"])
            out = dp.delta_pipeline_apply(*args, lr=0.7, aggregator=agg)
            ref = dp.delta_pipeline_ref(*args, lr=0.7, aggregator=agg)
            check(torch.equal(out, ref), f"{agg} with no client selected {shape_name}")
            say("kernels", kernel="delta_pipeline_apply", shape=shape_name,
                gates=f"{agg}, no client selected", equal=True,
                all_inf=bool(torch.isinf(out).all()))

    errs["delta_pipeline_partial"] = check_partial(torch, dp, dev)
    check_streaming_exact(torch, dp, fa, dev)
    errs["delta_pipeline_apply"] = max(errs["delta_pipeline_apply"],
                                       check_robust(torch, dp, dev))

    # ---- timing at the slice's shape (the main path's gates: plain Eq. 6)
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    c, segs = 64, SLICE_SEGS
    p = sum(segs)
    # Four copies of the 28.9 MB buffer (115 MB > the 50 MB L2), used in
    # turn, so each call reads its deltas from device memory as the round
    # does after local training has streamed other data through the cache.
    bufs = [make_inputs(torch, c, segs, 7 + i, dev) for i in range(4)]
    rows = [
        cu.pipeline_rows(b["upd"], b["mask"], b["weights"], None, 0.0, 0.1,
                         clip_norm=0.0, compression="none", topk_fraction=0.05,
                         seg_sizes=None, aggregator="fedavg")
        for b in bufs
    ]
    out = torch.empty((p,), device=dev)
    lr = 1.0

    def k3(i):
        b, (wn, cnt, pre, seg, tab) = bufs[i % 4], rows[i % 4]
        cu.launch_pipeline(b["upd"], b["base"], wn, cnt, pre, seg, tab, None, None,
                           out, None, lr=lr, server_momentum=0.9,
                           compression="none", aggregator="fedavg",
                           server_optimizer="fedavg")

    def k3_wrapper(i):
        b = bufs[i % 4]
        dp.delta_pipeline_apply(b["upd"], b["base"], b["mask"], b["weights"], lr=lr)

    def k3_plain(i):
        b = bufs[i % 4]
        dp.delta_pipeline_ref(b["upd"], b["base"], b["mask"], b["weights"], lr=lr)

    def k3_lib(i):
        b, wn = bufs[i % 4], rows[i % 4][0]
        torch.addmv(b["base"], b["upd"].t(), wn, alpha=lr, out=out)

    def k2(i):
        dp.delta_sq_norms(bufs[i % 4]["upd"])

    def k2_plain(i):
        dp.delta_sq_norms_ref(bufs[i % 4]["upd"])

    def k2_lib(i):
        u = bufs[i % 4]["upd"]
        torch.linalg.vecdot(u, u)

    # K4 on the population-and-fog path: one fog's 16-row block of the
    # (64, P) buffer, its unnormalized weights mask·|D|; the sixteen blocks
    # of the four buffers are used in turn (115 MB > L2).
    cl = c // 4
    blocks = [(b["upd"][f * cl:(f + 1) * cl],
               (b["mask"].float() * b["weights"])[f * cl:(f + 1) * cl].contiguous())
              for b in bufs for f in range(4)]
    out4 = torch.empty((p,), device=dev)

    def k4(i):
        x, dm = blocks[i % 16]
        cu.launch_partial(x, dm, None, None, None, out4, compression="none")

    def k4_plain(i):
        x, dm = blocks[i % 16]
        dp.delta_pipeline_partial_ref(x, dm)

    def k4_lib(i):
        x, dm = blocks[i % 16]
        torch.mv(x.t(), dm, out=out4)

    # K1 at the simulator's cohort on the same four buffers, its weight row
    # prepared as the wrapper makes it; and at kernels_bench's (32, 65,536)
    # with every client selected at weight 1, eight 8 MB buffers (> L2).
    from repro_torch.kernels.fedavg import fedavg as fa_cuda

    k1_rows = [fa_cuda.weight_row(b["mask"], b["weights"], lr) for b in bufs]
    out1 = torch.empty((p,), device=dev)

    def k1(i):
        b = bufs[i % 4]
        fa_cuda.launch_fedavg(b["upd"], b["base"], k1_rows[i % 4], out1)

    def k1_plain(i):
        b = bufs[i % 4]
        fa.fedavg_apply_ref(b["upd"], b["base"], b["mask"], b["weights"], lr=lr)

    def k1_lib(i):
        b = bufs[i % 4]
        torch.addmv(b["base"], b["upd"].t(), k1_rows[i % 4], out=out1)

    nb, db = 32, 1 << 16
    gb = torch.Generator(device=dev)
    gb.manual_seed(11)
    bench = [(torch.randn((nb, db), generator=gb, device=dev),
              torch.randn((db,), generator=gb, device=dev)) for _ in range(8)]
    ones_mask = torch.ones((nb,), dtype=torch.bool, device=dev)
    ones_w = torch.ones((nb,), device=dev)
    bench_row = fa_cuda.weight_row(ones_mask, ones_w, 1.0)
    outb = torch.empty((db,), device=dev)
    t_bench = {
        "k1": cuda_ms(lambda i: fa_cuda.launch_fedavg(*bench[i % 8], bench_row, outb), 400),
        "k1_plain": cuda_ms(lambda i: fa.fedavg_apply_ref(*bench[i % 8], ones_mask, ones_w), 100),
        "k1_lib": cuda_ms(lambda i: torch.addmv(bench[i % 8][1], bench[i % 8][0].t(),
                                                bench_row, out=outb), 400),
    }

    # K1 in bf16 at the cohort on eight 14.4 MB buffers (> L2), beside
    # torch.addmv in bf16 (its weight row rounded to bf16).
    bf_bufs = [(b["upd"].to(torch.bfloat16), b["base"].to(torch.bfloat16))
               for b in bufs + [make_inputs(torch, c, segs, 20 + i, dev) for i in range(4)]]
    bf_row = k1_rows[0]
    bf_row16 = bf_row.to(torch.bfloat16)
    outbf = torch.empty((p,), dtype=torch.bfloat16, device=dev)
    t_bf = {
        "k1": cuda_ms(lambda i: fa_cuda.launch_fedavg(*bf_bufs[i % 8], bf_row, outbf), 400),
        "k1_plain": cuda_ms(lambda i: fa.fedavg_apply_ref(
            *bf_bufs[i % 8], bufs[0]["mask"], bufs[0]["weights"]), 100),
        "k1_lib": cuda_ms(lambda i: torch.addmv(bf_bufs[i % 8][1], bf_bufs[i % 8][0].t(),
                                                bf_row16, out=outbf), 400),
    }
    # K3's median / trimmed route (robust_kernel), once at the slice,
    # beside its plain version.
    t_robust, t_robust_plain = {}, {}
    for agg in ("median", "trimmed"):
        r_rows = [cu.pipeline_rows(b["upd"], b["mask"], b["weights"], None, 0.0, 0.1,
                                   clip_norm=0.0, compression="none", topk_fraction=0.05,
                                   seg_sizes=None, aggregator=agg) for b in bufs]

        def k3_robust(i, agg=agg, r_rows=r_rows):
            b, (wn, cnt, pre, seg, tab) = bufs[i % 4], r_rows[i % 4]
            cu.launch_pipeline(b["upd"], b["base"], wn, cnt, pre, seg, tab, None, None,
                               out, None, lr=lr, server_momentum=0.9,
                               compression="none", aggregator=agg,
                               server_optimizer="fedavg")

        t_robust[agg] = cuda_ms(k3_robust, 200)
        t_robust_plain[agg] = cuda_ms(lambda i, agg=agg: dp.delta_pipeline_ref(
            bufs[i % 4]["upd"], bufs[i % 4]["base"], bufs[i % 4]["mask"],
            bufs[i % 4]["weights"], lr=lr, aggregator=agg), 20)

    # Their library yardsticks at the same shape and masks, the boolean row
    # gather x[mask] (a host synchronisation per call) included:
    # torch.median over the selected rows, and torch.sort + slice + mean
    # for the trimmed mean (k = floor(0.1 · selected) per side).
    k_trim = [int(0.1 * int(b["mask"].sum())) for b in bufs]

    def trimmed_lib(x, k):
        return torch.sort(x, dim=0).values[k:x.shape[0] - k].mean(dim=0)

    t_robust_lib = {
        "median": cuda_ms(lambda i: torch.median(bufs[i % 4]["upd"][bufs[i % 4]["mask"]],
                                                 dim=0), 20),
        "trimmed": cuda_ms(lambda i: trimmed_lib(bufs[i % 4]["upd"][bufs[i % 4]["mask"]],
                                                 k_trim[i % 4]), 20),
    }

    # K4 at two fogs (the fault runs' fog_nodes=2): a 32-row block, the
    # eight blocks of the four buffers used in turn.
    blocks32 = [(b["upd"][f * 32:(f + 1) * 32],
                 (b["mask"].float() * b["weights"])[f * 32:(f + 1) * 32].contiguous())
                for b in bufs for f in range(2)]
    for f, (x, dm32) in enumerate(blocks32):
        cu.launch_partial(x, dm32, None, None, None, out4, compression="none")
        same = torch.equal(out4, dp.delta_pipeline_partial_ref(x, dm32))
        check(same, f"delta_pipeline_partial at 32 rows, block {f}: not its plain version")
    say("kernels", kernel="delta_pipeline_partial", C_local=32, P=p, blocks=len(blocks32),
        timed_blocks_equal_to_plain=True)
    t4_32 = {
        "k4": cuda_ms(lambda i: cu.launch_partial(*blocks32[i % 8], None, None, None,
                                                  out4, compression="none"), 400),
        "k4_plain": cuda_ms(lambda i: dp.delta_pipeline_partial_ref(*blocks32[i % 8]), 20),
        "k4_lib": cuda_ms(lambda i: torch.mv(blocks32[i % 8][0].t(), blocks32[i % 8][1],
                                             out=out4), 400),
    }

    t = {
        "k1": cuda_ms(k1, 200), "k1_plain": cuda_ms(k1_plain, 100),
        "k1_lib": cuda_ms(k1_lib, 200),
        "k4": cuda_ms(k4, 400), "k4_plain": cuda_ms(k4_plain, 20),
        "k4_lib": cuda_ms(k4_lib, 400),
        "k3": cuda_ms(k3, 200), "k3_wrapper": cuda_ms(k3_wrapper, 200),
        "k3_plain": cuda_ms(k3_plain, 20), "k3_lib": cuda_ms(k3_lib, 200),
        "k2": cuda_ms(k2, 200), "k2_plain": cuda_ms(k2_plain, 100),
        "k2_lib": cuda_ms(k2_lib, 200),
    }
    k3_bytes = 4 * (c * p + p + p + c)  # deltas, base, out, weights row
    k2_bytes = 4 * (c * p + c)  # deltas, norms
    # One FMA (2 operations) per delta element in each; K3 adds lr·agg + base.
    by3 = (k3_bytes / HBM_BYTES_PER_S, 2 * (c * p + p) / FP32_FLOP_PER_S)
    by2 = (k2_bytes / HBM_BYTES_PER_S, 2 * c * p / FP32_FLOP_PER_S)
    k4_bytes = 4 * (cl * p + cl + p)  # one fog's deltas, its weights, out
    by4 = (k4_bytes / HBM_BYTES_PER_S, 2 * cl * p / FP32_FLOP_PER_S)
    # K1 moves K3's ungated bytes and does its FMAs.
    by1 = by3
    k1b_bytes = 4 * (nb * db + db + db + nb)
    by1b = (k1b_bytes / HBM_BYTES_PER_S, 2 * (nb * db + db) / FP32_FLOP_PER_S)
    bound1, bound1b = max(by1) * 1e3, max(by1b) * 1e3
    bound3, bound2, bound4 = max(by3) * 1e3, max(by2) * 1e3, max(by4) * 1e3
    bound_by3 = "bytes" if by3[0] >= by3[1] else "operations"
    bound_by2 = "bytes" if by2[0] >= by2[1] else "operations"
    bound_by4 = "bytes" if by4[0] >= by4[1] else "operations"
    say("timing", kernel="delta_pipeline_apply", C=c, P=p, ms=t["k3"],
        wrapper_ms=t["k3_wrapper"], plain_ms=t["k3_plain"], library_ms=t["k3_lib"],
        library="torch.addmv", bound_ms=bound3, bytes=k3_bytes,
        share_of_bound=bound3 / t["k3"])
    say("timing", kernel="fedavg_apply", N=c, D=p, dtype="float32", ms=t["k1"],
        plain_ms=t["k1_plain"], library_ms=t["k1_lib"], library="torch.addmv",
        bound_ms=bound1, bytes=k3_bytes, share_of_bound=bound1 / t["k1"])
    say("timing", kernel="fedavg_apply", shape="kernels_bench", N=nb, D=db,
        dtype="float32", ms=t_bench["k1"], plain_ms=t_bench["k1_plain"],
        library_ms=t_bench["k1_lib"], library="torch.addmv", bound_ms=bound1b,
        bytes=k1b_bytes, share_of_bound=bound1b / t_bench["k1"])
    k1bf_bytes = 2 * (c * p + p + p) + 4 * c
    bound1bf = max(k1bf_bytes / HBM_BYTES_PER_S, 2 * (c * p + p) / FP32_FLOP_PER_S) * 1e3
    say("timing", kernel="fedavg_apply", N=c, D=p, dtype="bfloat16", ms=t_bf["k1"],
        plain_ms=t_bf["k1_plain"], library_ms=t_bf["k1_lib"],
        library="torch.addmv (bf16)", bound_ms=bound1bf, bytes=k1bf_bytes,
        share_of_bound=bound1bf / t_bf["k1"])
    # The robust route reads the selected rows' deltas only (mean over the
    # four timed buffers' masks), the base, the mask row and the (2,) count
    # pair, and writes the output; its network does a min and a max per
    # compare-exchange of every column.
    n_sel = sum(int(b["mask"].sum()) for b in bufs) / len(bufs)
    robust_bytes = 4 * (n_sel * p + p + p + c + 2)
    robust_ops = 2 * ROBUST_NETWORK_PAIRS_64 * p
    byr = (robust_bytes / HBM_BYTES_PER_S, robust_ops / MINMAX_PER_S)
    bound_r = max(byr) * 1e3
    for agg, ms in t_robust.items():
        say("timing", kernel="delta_pipeline_apply", route="robust_kernel", aggregator=agg,
            C=c, P=p, selected=n_sel, ms=ms, plain_ms=t_robust_plain[agg],
            bound_ms=bound_r, bytes=robust_bytes, bytes_ms=byr[0] * 1e3,
            bound_by="bytes" if byr[0] >= byr[1] else "operations",
            network_ops=robust_ops, ops_ms=byr[1] * 1e3, share_of_bound=bound_r / ms,
            library_ms=t_robust_lib[agg],
            library="torch.median(x[mask], dim=0)" if agg == "median"
            else "torch.sort(x[mask], dim=0) + slice + mean")
    k4_32_bytes = 4 * (32 * p + 32 + p)
    by4_32 = (k4_32_bytes / HBM_BYTES_PER_S, 2 * 32 * p / FP32_FLOP_PER_S)
    bound4_32 = max(by4_32) * 1e3
    say("timing", kernel="delta_pipeline_partial", C_local=32, P=p, ms=t4_32["k4"],
        plain_ms=t4_32["k4_plain"], library_ms=t4_32["k4_lib"], library="torch.mv",
        bound_ms=bound4_32, bytes=k4_32_bytes, share_of_bound=bound4_32 / t4_32["k4"])
    fedavg_plan_line(torch, dp, "delta_pipeline_partial", 32, p, torch.float32)
    for name, cc, pp, dt in (("delta_pipeline_apply", c, p, torch.float32),
                             ("delta_pipeline_partial", cl, p, torch.float32),
                             ("fedavg_apply", c, p, torch.bfloat16),
                             ("fedavg_apply", nb, db, torch.float32)):
        fedavg_plan_line(torch, dp, name, cc, pp, dt)
    say("timing", kernel="delta_sq_norms", C=c, P=p, ms=t["k2"],
        plain_ms=t["k2_plain"], library_ms=t["k2_lib"],
        library="torch.linalg.vecdot", bound_ms=bound2, bytes=k2_bytes,
        share_of_bound=bound2 / t["k2"])
    say("timing", kernel="delta_pipeline_partial", C_local=cl, P=p, ms=t["k4"],
        plain_ms=t["k4_plain"], library_ms=t["k4_lib"], library="torch.mv",
        bound_ms=bound4, bytes=k4_bytes, share_of_bound=bound4 / t["k4"])
    src = "src/repro_torch/kernels/delta_pipeline/csrc/delta_pipeline.cu"
    pallas = "src/repro/kernels/delta_pipeline/delta_pipeline.py"
    return [
        {"name": "fedavg_apply", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/fedavg/fedavg.py:68", "launches": None,
         "on_main_path": False, "max_abs_err": errs["fedavg_apply"], "ms": t["k1"],
         "plain_ms": t["k1_plain"], "bound_ms": bound1,
         "bound_by": "bytes" if by1[0] >= by1[1] else "operations",
         "library_ms": t["k1_lib"], "bf16_ms": t_bf["k1"], "bf16_plain_ms": t_bf["k1_plain"],
         "bf16_bound_ms": bound1bf, "bf16_library_ms": t_bf["k1_lib"]},
        {"name": "delta_sq_norms", "route": "cuda", "source": src,
         "replaces": f"{pallas}:80", "launches": None, "on_main_path": False,
         "max_abs_err": errs["delta_sq_norms"], "ms": t["k2"],
         "plain_ms": t["k2_plain"], "bound_ms": bound2, "bound_by": bound_by2,
         "library_ms": t["k2_lib"]},
        {"name": "delta_pipeline_apply", "route": "cuda", "source": src,
         "replaces": f"{pallas}:436", "launches": None, "on_main_path": True,
         "max_abs_err": errs["delta_pipeline_apply"], "ms": t["k3"],
         "plain_ms": t["k3_plain"], "bound_ms": bound3, "bound_by": bound_by3,
         "library_ms": t["k3_lib"], "median_ms": t_robust["median"],
         "trimmed_ms": t_robust["trimmed"], "median_library_ms": t_robust_lib["median"],
         "trimmed_library_ms": t_robust_lib["trimmed"],
         "median_plain_ms": t_robust_plain["median"],
         "trimmed_plain_ms": t_robust_plain["trimmed"], "robust_bound_ms": bound_r,
         "robust_bound_by": "bytes" if byr[0] >= byr[1] else "operations"},
        {"name": "delta_pipeline_partial", "route": "cuda", "source": src,
         "replaces": f"{pallas}:536", "launches": None, "on_main_path": True,
         "max_abs_err": errs["delta_pipeline_partial"], "ms": t["k4"],
         "plain_ms": t["k4_plain"], "bound_ms": bound4, "bound_by": bound_by4,
         "library_ms": t["k4_lib"], "rows32_ms": t4_32["k4"],
         "rows32_plain_ms": t4_32["k4_plain"], "rows32_bound_ms": bound4_32,
         "rows32_library_ms": t4_32["k4_lib"]},
    ]


# ---- K5 (flash-attention forward) and K7 (paged decode attention) ------ #
# Shapes of the serving slice: llama3.2-1b's 32 query / 8 kv heads of 64,
# a 128-token prompt in one prefill (B = 1), 8 slots of 16-token pages.
LLAMA = dict(h=32, hkv=8, hd=64)
PROMPT, SLOTS, PAGE, MAX_GEN = 128, 8, 16, 32
# (name, B, H, Hkv, Sq, Sk, hd, window (kernel convention, 0 = global),
# bidirectional, dtype)
K5_CASES = [
    ("slice", 1, 32, 8, PROMPT, PROMPT, 64, 0, False, "bfloat16"),
    ("window", 1, 32, 8, PROMPT, PROMPT, 64, 48, False, "bfloat16"),
    ("bidirectional", 1, 32, 8, PROMPT, PROMPT, 64, 0, True, "bfloat16"),
    ("gqa1", 2, 8, 8, 96, 96, 64, 0, False, "bfloat16"),
    ("sq<sk, ragged tiles", 1, 32, 8, 40, 200, 64, 0, False, "bfloat16"),
    ("ragged, window, hd 128", 2, 4, 1, 77, 77, 128, 20, False, "bfloat16"),
    ("float32", 1, 8, 2, 64, 64, 64, 0, False, "float32"),
    ("float32, hd 16, ragged", 1, 4, 2, 33, 33, 16, 0, False, "float32"),
    # the bf16 (tensor-core) route over several 64-key tiles, every head
    # dim, and GQA 8 (two blocks of four heads per kv head)
    ("S 200", 1, 32, 8, 200, 200, 64, 0, False, "bfloat16"),
    ("S 200, hd 128, gqa 8", 1, 16, 2, 200, 200, 128, 0, False, "bfloat16"),
    ("hd 32, bidirectional, ragged", 2, 8, 2, 50, 50, 32, 0, True, "bfloat16"),
    ("hd 16, window", 1, 4, 4, 70, 70, 16, 9, False, "bfloat16"),
    ("float32, S 200, window", 1, 8, 2, 200, 200, 64, 70, False, "float32"),
    # head_dim 256 (gemma3-12b: 16 heads over 8, local window 1,024): the
    # bf16 route keeps q in shared memory and takes 32-key tiles there
    ("hd 256, gemma3 local, S 2048", 1, 16, 8, 2048, 2048, 256, 1024, False, "bfloat16"),
    ("hd 256, gemma3 global, S 2048", 1, 16, 8, 2048, 2048, 256, 0, False, "bfloat16"),
    ("hd 256, gemma3 prefill", 1, 16, 8, PROMPT, PROMPT, 256, 1024, False, "bfloat16"),
    ("hd 256, gqa 4, bidirectional, ragged", 2, 8, 2, 77, 77, 256, 0, True, "bfloat16"),
    ("hd 256, float32, window", 1, 4, 2, 300, 300, 256, 100, False, "float32"),
    # the HYBRID, VLM and ENCDEC families: hymba-1.5b's group of 5 (25 over
    # 5 heads of 64), global and past its 1,024 window; internvl2-2b's
    # 136-row prompt (128 tokens and 8 patches) at head_dim 128;
    # seamless-m4t-medium's bidirectional encoder and cross-attention (16
    # over 16 heads of 64; Sq 128 and Sq 1 against 128 source frames)
    ("hymba prefill, gqa 5", 1, 25, 5, PROMPT, PROMPT, 64, 1024, False, "bfloat16"),
    ("hymba, gqa 5, past the window", 1, 25, 5, 1100, 1100, 64, 1024, False, "bfloat16"),
    ("hymba, gqa 5, global, S 1100", 1, 25, 5, 1100, 1100, 64, 0, False, "bfloat16"),
    ("hymba, gqa 5, float32", 1, 25, 5, 200, 200, 64, 0, False, "float32"),
    ("internvl2 prefill, 136 rows", 1, 16, 8, PROMPT + 8, PROMPT + 8, 128, 0, False,
     "bfloat16"),
    ("seamless encoder / cross, Sq 128, Sk 128", 8, 16, 16, PROMPT, PROMPT, 64, 0, True,
     "bfloat16"),
    ("seamless decoder, causal", 8, 16, 16, PROMPT, PROMPT, 64, 0, False, "bfloat16"),
    ("seamless decode cross, Sq 1, Sk 128", 8, 16, 16, 1, PROMPT, 64, 0, True, "bfloat16"),
    ("seamless cross, Sq 1, float32", 8, 16, 16, 1, PROMPT, 64, 0, True, "float32"),
]
# K7 at head_dim 256: 130 pages of 16 (2,080 keys: 8 blocks of 17 pages)
K7_256_PAGES = 130
K7_256_LENGTHS = [2080, 1025, 1500, 0, 1, 2048, 1024, 1800]
# (name, slots, Hkv, g, hd, page, pages per slot, window (model convention,
# -1 = global), dtype, lengths or None for the slice's 129..160)
K7_CASES = [
    ("slice", SLOTS, 8, 4, 64, PAGE, 10, -1, "bfloat16", None),
    ("ragged, empty slots", SLOTS, 8, 4, 64, PAGE, 10, -1, "bfloat16",
     [0, 1, 16, 17, 0, 160, 95, 33]),
    ("window", SLOTS, 8, 4, 64, PAGE, 10, 40, "bfloat16", None),
    ("gqa1, hd 128", 3, 1, 1, 128, 16, 2, -1, "float32", [5, 32, 0]),
    ("window < page span", 5, 2, 2, 64, 4, 5, 6, "float32", [20, 3, 0, 11, 7]),
    ("gqa2, window", 4, 2, 2, 64, 8, 4, 12, "bfloat16", [32, 9, 1, 25]),
    # the split plan's boundaries (10 pages: 5 blocks of 2): one live
    # token, fewer live pages than splits, a split's edge and across it,
    # the full n_pages·page; a window that kills whole splits; 40 pages
    # (8 blocks of 5, more than the 4-page ring); g 8 with hd 128
    ("split edges", SLOTS, 8, 4, 64, PAGE, 10, -1, "bfloat16",
     [1, 31, 32, 33, 160, 0, 64, 65]),
    ("window kills splits", SLOTS, 8, 4, 64, PAGE, 10, 20, "bfloat16",
     [160, 150, 100, 1, 0, 37, 80, 129]),
    ("40 pages, ring", 4, 8, 4, 64, PAGE, 40, -1, "bfloat16", [640, 300, 1, 0]),
    ("40 pages, ring, window", 4, 2, 4, 64, PAGE, 40, 100, "float32", [640, 300, 99, 0]),
    ("gqa8, hd 128", 3, 2, 8, 128, 32, 3, -1, "bfloat16", [96, 33, 0]),
    # head_dim 256 (gemma3-12b: g 2), lengths past the 1,024 window
    ("hd 256, gemma3, window 1024", SLOTS, 8, 2, 256, PAGE, K7_256_PAGES, 1024, "bfloat16",
     K7_256_LENGTHS),
    ("hd 256, gemma3, global", SLOTS, 8, 2, 256, PAGE, K7_256_PAGES, -1, "bfloat16",
     K7_256_LENGTHS),
    ("hd 256, gemma3 decode step", SLOTS, 8, 2, 256, PAGE, 10, 1024, "bfloat16", None),
    ("hd 256, float32, window", 4, 2, 4, 256, PAGE, 20, 100, "float32", [320, 101, 0, 7]),
    # hymba-1.5b's decode (g 5, hd 64), its window and the global layers;
    # internvl2-2b's (g 2, hd 128) over 136 + 32 positions
    ("hymba decode step, gqa 5", SLOTS, 5, 5, 64, PAGE, 10, 1024, "bfloat16", None),
    ("hymba, gqa 5, past the window", 4, 5, 5, 64, PAGE, 80, 1024, "bfloat16",
     [1280, 1025, 1024, 0]),
    ("hymba, gqa 5, float32", 4, 5, 5, 64, PAGE, 80, -1, "float32", [1280, 1, 700, 0]),
    ("internvl2 decode step", SLOTS, 8, 2, 128, PAGE, 11, -1, "bfloat16",
     [137, 168, 140, 0, 1, 150, 160, 138]),
]
# bf16 outputs: the kernel and the plain version both compute in float32
# and round once to bf16, in another order; they may land one bf16 step
# (2^-7 relative) apart. float32: summation order only.
ATTN_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-5, 1e-5)}


def attn_err(torch, out, ref, dtype, what):
    rtol, atol = ATTN_TOL[dtype]
    o, r = out.float(), ref.float()
    check(bool(torch.isfinite(o).all()), f"{what}: non-finite output")
    err = float((o - r).abs().max())
    bad = (o - r).abs() > atol + rtol * r.abs()
    check(not bool(bad.any()), f"{what}: max_abs_err {err} beyond {atol} + {rtol}|ref|")
    return err


def paged_inputs(torch, s, hkv, g, hd, page, n, dtype, lengths, seed, dev):
    """Pools with every page filled (trash page 0 and stale pages too),
    a page table of shuffled physical pages whose entries past each slot's
    live pages name the trash page 0, and the lengths."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = dict(generator=gen, device=dev)
    dt = getattr(torch, dtype)
    q = torch.randn((s, hkv * g, hd), **f).to(dt)
    kp = torch.randn((s * n + 1, page, hkv, hd), **f).to(dt)
    vp = torch.randn((s * n + 1, page, hkv, hd), **f).to(dt)
    if lengths is None:
        lengths = (torch.randint(PROMPT + 1, PROMPT + MAX_GEN + 1, (s,), **f)).tolist()
    perm = torch.randperm(s * n, **f) + 1
    table = torch.zeros((s, n), dtype=torch.int32, device=dev)
    for i, ln in enumerate(lengths):
        live = -(-ln // page)
        table[i, :live] = perm[i * n:i * n + live].int()
    return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


def phase_attention_kernels(torch):
    """K5 and K7 against their plain versions at every case, then timed at
    the slice's shapes. Returns their dicts for the JSON line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import (gather_pages, paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.paged_attention import (paged_attention_cuda,
                                                                     split_plan)

    dev = torch.device("cuda")
    errs = {"flash_attention_fwd": 0.0, "paged_attention_fwd": 0.0}
    for i, (name, b, h, hkv, sq, sk, hd, win, bidir, dtype) in enumerate(K5_CASES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(100 + i)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt) for shape in
                   ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
        # the model layout through ops (the main path), and the Pallas
        # layout's contiguous (B, H, S, hd) tensors as strided views, both
        # against the plain version
        out = flash_attention(q, k, v, window=win if win > 0 else -1, bidirectional=bidir)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out_t = flash_attention_cuda(*(x.transpose(1, 2) for x in (qt, kt, vt)),
                                     window=win, bidirectional=bidir)
        ref = flash_attention_ref(qt, kt, vt, window=win, bidirectional=bidir)
        torch.cuda.synchronize()
        e1 = attn_err(torch, out.transpose(1, 2), ref, dtype, f"flash {name} (model layout)")
        e2 = attn_err(torch, out_t.transpose(1, 2), ref, dtype, f"flash {name} (strided)")
        rtol, atol = ATTN_TOL[dtype]
        say("kernels", kernel="flash_attention_fwd", case=repr(name), B=b, H=h, Hkv=hkv,
            Sq=sq, Sk=sk, hd=hd, window=win, bidirectional=bidir, dtype=dtype,
            max_abs_err=max(e1, e2), atol=atol, rtol=rtol)
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], e1, e2)
    for i, (name, s, hkv, g, hd, page, n, win, dtype, lengths) in enumerate(K7_CASES):
        q, kp, vp, table, lens = paged_inputs(torch, s, hkv, g, hd, page, n, dtype,
                                              lengths, 200 + i, dev)
        out = paged_attention(q, kp, vp, table, lens, win)
        raw = paged_attention_cuda(q, kp, vp, table, lens, window=max(win, 0))
        # The plain version (gather + attention_decode) runs in the model
        # dtype and so rounds the scores and the softmax weights to bf16,
        # where the kernel keeps both in float32. Held here: the plain
        # version on the same values in float32, rounded once to bf16.
        # Printed beside it: the distance to the plain version in bf16.
        ref = paged_attention_ref(q.float(), kp.float(), vp.float(), table, lens,
                                  win).to(q.dtype)
        ref_lp = paged_attention_ref(q, kp, vp, table, lens, win)
        torch.cuda.synchronize()
        err = attn_err(torch, out, ref, dtype, f"paged {name}")
        check(bool((out[lens == 0] == 0).all()), f"paged {name}: empty slot not zero")
        check(bool((raw[lens == 0] == 0).all()), f"paged {name}: the kernel's empty slot")
        check(torch.equal(raw[lens > 0], out[lens > 0]), f"paged {name}: ops vs kernel")
        rtol, atol = ATTN_TOL[dtype]
        splits, pps = split_plan(n)
        say("kernels", kernel="paged_attention_fwd", case=repr(name), slots=s, Hkv=hkv,
            g=g, hd=hd, page=page, pages_per_slot=n, splits=splits, pages_per_split=pps,
            window=win, dtype=dtype,
            lengths=lens.tolist(), max_abs_err=err, atol=atol, rtol=rtol,
            max_abs_diff_to_plain_in_model_dtype=float((out.float() - ref_lp.float()).abs().max()))
        errs["paged_attention_fwd"] = max(errs["paged_attention_fwd"], err)

    # ---- timing at the slice's shapes
    h, hkv, hd = LLAMA["h"], LLAMA["hkv"], LLAMA["hd"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    bf = torch.bfloat16
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf) for shape in
               ((1, PROMPT, h, hd), (1, PROMPT, hkv, hd), (1, PROMPT, hkv, hd)))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    n_tab = -(-(PROMPT + MAX_GEN) // PAGE)
    pq, kp, vp, table, lens = paged_inputs(torch, SLOTS, hkv, h // hkv, hd, PAGE, n_tab,
                                           "bfloat16", None, 8, dev)
    kg = gather_pages(kp, table).transpose(1, 2).contiguous()  # (S, Hkv, n*page, hd)
    vg = gather_pages(vp, table).transpose(1, 2).contiguous()
    kmask = (torch.arange(n_tab * PAGE, device=dev)[None, :] < lens[:, None].long())
    kmask = kmask[:, None, None, :]  # (S, 1, 1, n*page)
    t = {
        "k5": cuda_ms(lambda i: flash_attention_cuda(q, k, v), 400),
        "k5_plain": cuda_ms(lambda i: flash_attention_ref(qt, kt, vt), 100),
        "k5_lib": cuda_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 400),
        "k7": cuda_ms(lambda i: paged_attention_cuda(pq, kp, vp, table, lens), 400),
        "k7_plain": cuda_ms(lambda i: paged_attention_ref(pq, kp, vp, table, lens), 100),
        "k7_lib": cuda_ms(lambda i: F.scaled_dot_product_attention(
            pq[:, :, None], kg, vg, attn_mask=kmask, enable_gqa=True), 400),
    }
    el = 2  # bytes per bf16 element
    k5_bytes = el * (2 * PROMPT * h * hd + 2 * PROMPT * hkv * hd)  # q, out; k, v
    pairs = PROMPT * (PROMPT + 1) // 2  # causal (q, k) pairs per head
    k5_ops = 4 * h * pairs * hd  # q·k and p·v, 2 operations per FMA
    live = int(lens.sum())  # keys the lengths make live, over all slots
    k7_bytes = (el * (2 * live * hkv * hd + 2 * SLOTS * h * hd)
                + 4 * (SLOTS * n_tab + SLOTS))  # k, v; q, out; table, lengths
    k7_ops = 4 * live * h * hd
    by5 = (k5_bytes / HBM_BYTES_PER_S, k5_ops / BF16_FLOP_PER_S)
    by7 = (k7_bytes / HBM_BYTES_PER_S, k7_ops / BF16_FLOP_PER_S)
    b5, b7 = max(by5) * 1e3, max(by7) * 1e3
    say("timing", kernel="flash_attention_fwd", B=1, H=h, Hkv=hkv, S=PROMPT, hd=hd,
        dtype="bfloat16", ms=t["k5"], plain_ms=t["k5_plain"], library_ms=t["k5_lib"],
        library="F.scaled_dot_product_attention(is_causal, enable_gqa)", bound_ms=b5,
        bytes=k5_bytes, operations=k5_ops, share_of_bound=b5 / t["k5"])
    splits, pps = split_plan(n_tab)
    say("timing", kernel="paged_attention_fwd", split_plan=f"{splits} x {pps} pages",
        grid=[splits, hkv, SLOTS], cluster=[splits, 1, 1], threads=32 * (h // hkv))
    say("timing", kernel="paged_attention_fwd", slots=SLOTS, Hkv=hkv, g=h // hkv, hd=hd,
        page=PAGE, lengths=lens.tolist(), dtype="bfloat16", ms=t["k7"],
        plain_ms=t["k7_plain"], library_ms=t["k7_lib"],
        library="F.scaled_dot_product_attention over the pre-gathered cache",
        bound_ms=b7, bytes=k7_bytes, operations=k7_ops, share_of_bound=b7 / t["k7"])
    return [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:146",
         "launches": None, "on_main_path": True,
         "max_abs_err": errs["flash_attention_fwd"], "ms": t["k5"],
         "plain_ms": t["k5_plain"], "bound_ms": b5,
         "bound_by": "bytes" if by5[0] >= by5[1] else "operations",
         "library_ms": t["k5_lib"]},
        {"name": "paged_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/paged_attention.py:159",
         "launches": None, "on_main_path": True,
         "max_abs_err": errs["paged_attention_fwd"], "ms": t["k7"],
         "plain_ms": t["k7_plain"], "bound_ms": b7,
         "bound_by": "bytes" if by7[0] >= by7[1] else "operations",
         "library_ms": t["k7_lib"]},
    ]


# ---- K5 and K7 at head_dim 256 (gemma3-12b), timed ------------------- #
GEMMA = dict(h=16, hkv=8, hd=256, window=1024)
K5_256_S = 2048


def causal_pairs(sq: int, sk: int, window: int) -> int:
    """(q, k) pairs a causal mask (q rows at the tail of the keys) with an
    optional window (0 = global) leaves visible, per head."""
    off = sk - sq
    return sum(min(off + i + 1, window) if window > 0 else off + i + 1 for i in range(sq))


def time_attention_256(torch) -> dict:
    """K5 at (1, 2,048, 16 over 8, 256) and K7 at 8 slots of 1,025..2,080
    keys (16 over 8, 256), each with gemma3's local window of 1,024 and
    global, beside the plain version, the bound and SDPA. Returns
    {kernel: {"window" | "global": {ms, plain_ms, bound_ms, bound_by,
    library_ms}}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import gather_pages, paged_attention_ref
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_cuda

    dev = torch.device("cuda")
    h, hkv, hd, w = GEMMA["h"], GEMMA["hkv"], GEMMA["hd"], GEMMA["window"]
    s = K5_256_S
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    bf = torch.bfloat16
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf) for shape in
               ((1, s, h, hd), (1, s, hkv, hd), (1, s, hkv, hd)))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    n_tab = K7_256_PAGES
    lengths = torch.randint(1025, n_tab * PAGE + 1, (SLOTS,), generator=gen, device=dev)
    pq, kp, vp, table, lens = paged_inputs(torch, SLOTS, hkv, h // hkv, hd, PAGE, n_tab,
                                           "bfloat16", lengths.tolist(), 10, dev)
    kg = gather_pages(kp, table).transpose(1, 2).contiguous()  # (S, Hkv, n*page, hd)
    vg = gather_pages(vp, table).transpose(1, 2).contiguous()
    pos = torch.arange(s, device=dev)
    kpos = torch.arange(n_tab * PAGE, device=dev)[None, :]
    el = 2
    out = {"flash_attention_fwd": {}, "paged_attention_fwd": {}}
    for name, win in (("window", w), ("global", 0)):
        vis = pos[None, :] <= pos[:, None]
        if win:
            vis = vis & (pos[:, None] - pos[None, :] < win)
        qpos = lens[:, None].long() - 1
        kvis = kpos <= qpos
        if win:
            kvis = kvis & (qpos - kpos < win)
        kmask = kvis[:, None, None, :]
        t = {
            "k5": cuda_ms(lambda i: flash_attention_cuda(q, k, v, window=win), 100),
            "k5_plain": cuda_ms(lambda i: flash_attention_ref(qt, kt, vt, window=win), 10, 2),
            "k5_lib": cuda_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True) if not win else
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis, enable_gqa=True),
                100),
            "k7": cuda_ms(lambda i: paged_attention_cuda(pq, kp, vp, table, lens, window=win),
                          200),
            "k7_plain": cuda_ms(lambda i: paged_attention_ref(pq, kp, vp, table, lens,
                                                              win if win else -1), 20, 2),
            "k7_lib": cuda_ms(lambda i: F.scaled_dot_product_attention(
                pq[:, :, None], kg, vg, attn_mask=kmask, enable_gqa=True), 200),
        }
        k5_bytes = el * (2 * s * h * hd + 2 * s * hkv * hd)
        k5_ops = 4 * h * causal_pairs(s, s, win) * hd
        live = int(torch.clamp(lens, max=win).sum()) if win else int(lens.sum())
        k7_bytes = el * (2 * live * hkv * hd + 2 * SLOTS * h * hd) + 4 * (SLOTS * n_tab + SLOTS)
        k7_ops = 4 * live * h * hd
        for kern, key, nbytes, ops in (("flash_attention_fwd", "k5", k5_bytes, k5_ops),
                                       ("paged_attention_fwd", "k7", k7_bytes, k7_ops)):
            by = (nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S)
            rec = {"ms": t[key], "plain_ms": t[f"{key}_plain"], "bound_ms": max(by) * 1e3,
                   "bound_by": "bytes" if by[0] >= by[1] else "operations",
                   "library_ms": t[f"{key}_lib"]}
            out[kern][name] = rec
            shape = (dict(B=1, S=s) if key == "k5" else
                     dict(slots=SLOTS, page=PAGE, lengths=lens.tolist()))
            say("timing", kernel=kern, hd=hd, H=h, Hkv=hkv, window=win, dtype="bfloat16",
                **shape, bytes=nbytes, operations=ops, **rec,
                library="F.scaled_dot_product_attention" + (
                    " (causal, GQA)" if key == "k5" and not win else
                    " (boolean mask, GQA)" if key == "k5" else
                    " over the pre-gathered cache"),
                share_of_bound=rec["bound_ms"] / rec["ms"])
    return out


# ---- K5 and K7 at the HYBRID, VLM and ENCDEC families' shapes, timed -- #
# (name, B, H, Hkv, Sq, Sk, hd, window (0 = global), bidirectional): the
# prefill and cross-attention shapes each family's path gives K5
K5_FAMILY_TIMES = [
    ("hymba prefill", 1, 25, 5, PROMPT, PROMPT, 64, 1024, False),
    ("hymba, S 2048, window 1024", 1, 25, 5, 2048, 2048, 64, 1024, False),
    ("internvl2 prefill", 1, 16, 8, PROMPT + 8, PROMPT + 8, 128, 0, False),
    ("seamless encoder", 8, 16, 16, PROMPT, PROMPT, 64, 0, True),
    ("seamless decoder", 8, 16, 16, PROMPT, PROMPT, 64, 0, False),
    ("seamless prefill cross", 8, 16, 16, PROMPT, PROMPT, 64, 0, True),
    ("seamless decode cross", 8, 16, 16, 1, PROMPT, 64, 0, True),
]
# (name, Hkv, g, hd, pages per slot, window (model convention)): one decode
# step of 8 slots at 129..168 positions
K7_FAMILY_TIMES = [
    ("hymba decode, window", 5, 5, 64, 10, 1024),
    ("internvl2 decode", 8, 2, 128, 11, -1),
]


def time_attention_families(torch) -> dict:
    """K5 and K7 at the shapes of hymba-1.5b, internvl2-2b and
    seamless-m4t-medium (``time_attention_cases``)."""
    return time_attention_cases(torch, K5_FAMILY_TIMES, K7_FAMILY_TIMES, 300)


def time_attention_cases(torch, k5_cases, k7_cases, seed: int) -> dict:
    """K5 at each of ``k5_cases`` and K7 at each of ``k7_cases`` (as
    ``K5_FAMILY_TIMES`` / ``K7_FAMILY_TIMES``), bf16: each kernel's output
    held against its plain version on the same inputs (``ATTN_TOL``, as in
    phase 3; K7's plain version in float32, rounded once), then timed
    beside the plain version, the bound and SDPA. Returns {kernel: {case:
    {ms, plain_ms, bound_ms, bound_by, library_ms, max_abs_err}}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import gather_pages, paged_attention_ref
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_cuda

    dev = torch.device("cuda")
    bf, el = torch.bfloat16, 2
    out = {"flash_attention_fwd": {}, "paged_attention_fwd": {}}

    def record(kern, name, t, nbytes, ops, err, **shape):
        by = (nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S)
        rec = {"ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": max(by) * 1e3,
               "bound_by": "bytes" if by[0] >= by[1] else "operations",
               "library_ms": t["library"], "max_abs_err": err}
        out[kern][name] = rec
        say("timing", kernel=kern, case=repr(name), dtype="bfloat16", **shape, bytes=nbytes,
            operations=ops, **rec, share_of_bound=rec["bound_ms"] / rec["ms"])

    for i, (name, b, h, hkv, sq, sk, hd, win, bidir) in enumerate(k5_cases):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + i)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(bf) for shape in
                   ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        err = attn_err(torch, flash_attention_cuda(q, k, v, window=win,
                                                   bidirectional=bidir).transpose(1, 2),
                       flash_attention_ref(qt, kt, vt, window=win, bidirectional=bidir),
                       "bfloat16", f"flash {name} (timed shape)")
        qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=dev)[None, :]
        vis = (kpos <= qpos) & ((qpos - kpos < win) if win else True)
        if bidir:
            lib = lambda i: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)  # noqa: E731
        elif (win and win < sk) or sq != sk:  # is_causal aligns the queries to key 0
            lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=vis, enable_gqa=True)
        else:
            lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        n = 200 if sq * sk <= PROMPT * PROMPT else 50
        t = {"kernel": cuda_ms(lambda i: flash_attention_cuda(q, k, v, window=win,
                                                               bidirectional=bidir), n),
             "plain": cuda_ms(lambda i: flash_attention_ref(qt, kt, vt, window=win,
                                                            bidirectional=bidir), 20, 2),
             "library": cuda_ms(lib, n)}
        pairs = sq * sk if bidir else causal_pairs(sq, sk, win)
        record("flash_attention_fwd", name, t,
               el * b * (2 * sq * h * hd + 2 * sk * hkv * hd), 4 * b * h * pairs * hd, err,
               B=b, H=h, Hkv=hkv, Sq=sq, Sk=sk, hd=hd, window=win, bidirectional=bidir)
    for i, (name, hkv, g, hd, n_tab, win) in enumerate(k7_cases):
        h = hkv * g
        pq, kp, vp, table, lens = paged_inputs(torch, SLOTS, hkv, g, hd, PAGE, n_tab,
                                               "bfloat16", None, seed + 100 + i, dev)
        kg = gather_pages(kp, table).transpose(1, 2).contiguous()
        vg = gather_pages(vp, table).transpose(1, 2).contiguous()
        kpos = torch.arange(n_tab * PAGE, device=dev)[None, :]
        qpos = lens[:, None].long() - 1
        kvis = (kpos <= qpos) & ((qpos - kpos < win) if win > 0 else True)
        kmask = kvis[:, None, None, :]
        err = attn_err(torch, paged_attention_cuda(pq, kp, vp, table, lens, window=max(win, 0)),
                       paged_attention_ref(pq.float(), kp.float(), vp.float(), table, lens,
                                           win).to(bf),
                       "bfloat16", f"paged {name} (timed shape)")
        t = {"kernel": cuda_ms(lambda i: paged_attention_cuda(pq, kp, vp, table, lens,
                                                              window=max(win, 0)), 400),
             "plain": cuda_ms(lambda i: paged_attention_ref(pq, kp, vp, table, lens, win),
                              50, 2),
             "library": cuda_ms(lambda i: F.scaled_dot_product_attention(
                 pq[:, :, None], kg, vg, attn_mask=kmask, enable_gqa=True), 400)}
        live = int(torch.clamp(lens, max=win).sum()) if win > 0 else int(lens.sum())
        record("paged_attention_fwd", name, t,
               el * (2 * live * hkv * hd + 2 * SLOTS * h * hd) + 4 * (SLOTS * n_tab + SLOTS),
               4 * live * h * hd, err, slots=SLOTS, Hkv=hkv, g=g, hd=hd, page=PAGE, window=win,
               lengths=lens.tolist())
    return out


# ---- K6 (the RWKV6 recurrence) ---------------------------------------- #
# rwkv6-1.6b's prefill: 32 wkv heads of 64, one 128-token prompt (B = 1).
RWKV_HEADS = 32
# (name, B, T, H, dtype, range of ww in w = exp(-exp(ww)), strided views)
K6_CASES = [
    ("slice", 1, PROMPT, RWKV_HEADS, "bfloat16", (-4.0, 0.5), False),
    ("ragged T, B 2", 2, 100, RWKV_HEADS, "bfloat16", (-4.0, 0.5), False),
    ("T < 32", 1, 20, 4, "bfloat16", (-4.0, 0.5), False),
    ("float32", 2, 64, 4, "float32", (-4.0, 0.5), False),
    ("strided views, ragged", 2, 77, 4, "float32", (-4.0, 0.5), True),
    ("strong decay, float32", 1, PROMPT, 8, "float32", (-4.0, 3.0), False),
    ("strong decay", 1, PROMPT, RWKV_HEADS, "bfloat16", (-4.0, 3.0), False),
    ("strided views, bf16", 1, 50, 4, "bfloat16", (-4.0, 0.5), True),
    ("long T, the state carried over 16 windows", 1, 2048, RWKV_HEADS, "bfloat16",
     (-4.0, 0.5), False),
]
# y: both compute in float32 and round once to the input dtype. The
# kernel works in chunks (a state carried from chunk to chunk, the steps
# within one summed as scores times v) and forms each decay as a running
# product of the chunk's clamped w <= 1; the plain version steps through
# T, multiplying its state by w at every step. So the two sum y's terms in
# different orders and reach each decay by different products of the same
# w, a few float32 roundings apart, and the kernel's final products for y
# run on the tensor cores in 3xTF32 (about 2^-20 of each): float32 outputs
# agree to 1e-5, and bf16 outputs may land one bf16 step (2^-7 relative)
# apart. Both plus 1e-5 of
# max |y| for the sums' cancellations. State: float32, the same terms
# summed in another order, within 1e-5 of its max |S|.
K6_Y_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
K6_ATOL_OF_MAX = 1e-5
WKV_CHUNK = 32  # the TPU kernel's chunk


def wkv6_plan(lib, b, h) -> dict:
    """K6's launch plan from its library (``fedfog_wkv6_plan``)."""
    import ctypes

    out = (ctypes.c_int * 7)()
    lib.fedfog_wkv6_plan(b, h, out)
    keys = ("chunk", "window", "threads", "grid_x", "grid_y", "grid_z", "smem_bytes")
    return dict(zip(keys, out))


def wkv6_ptxas(log_text: str) -> list[dict]:
    """The K6 kernel's instantiations in an `-Xptxas -v` report: dtype,
    loads, registers, stack, spill stores and loads."""
    out = []
    for entry in ptxas_entries(log_text, "wkv6_chunked_kernel"):
        mangled = entry.pop("mangled")
        out.append({"kernel": "wkv6_chunked_kernel",
                    "dtype": "bfloat16" if "bfloat16" in mangled else "float32",
                    "loads": "16-byte" if "Lb1E" in mangled else "element", **entry})
    return out


def k6_ops(b, t, h, dk=64, dv=64):
    """Floating-point operations of the RWKV6 recurrence over (B, T, H): the
    smaller of the stepwise form's and the TPU kernel's chunked form's.
    Stepwise, per step and head: r·S (2·K·V), the bonus (r·(u⊙k))·v
    (3·K + 2·V) and S = fma(w, S, k·v) (3·K·V). Chunked, per chunk and
    head: inter r̃·S and the carry k̃ᵀ·v (2·C·K·V each), scores r̃·k̃ᵀ
    (2·C²·K) and scores·v (2·C²·V)."""
    step = b * h * t * (5 * dk * dv + 3 * dk + 2 * dv)
    nc = -(-t // WKV_CHUNK)
    chunked = b * h * nc * (4 * WKV_CHUNK * dk * dv + 2 * WKV_CHUNK ** 2 * (dk + dv))
    return min(step, chunked)


def k6_bound(b, t, h, dtype):
    """K6's bound over (B, T, H), K = V = 64: (ms, "bytes" or "operations",
    bytes, operations), the larger of the bytes moved (each input read
    once, each output written once) over the HBM rate and the operations
    (``k6_ops``) over the float32 rate."""
    el = 2 if dtype == "bfloat16" else 4
    n_bytes = el * 4 * b * t * h * 64 + 4 * h * 64 + el * b * t * h * 64 + 4 * b * h * 64 * 64
    n_ops = k6_ops(b, t, h)
    by = (n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S)
    return max(by) * 1e3, "bytes" if by[0] >= by[1] else "operations", n_bytes, n_ops


def k6_compare(torch, y, s, yp, sp):
    """K6's (y, state) against its plain version's on the same inputs: y to
    K6_Y_RTOL of its dtype plus K6_ATOL_OF_MAX of max |y|, the state to
    K6_ATOL_OF_MAX of max |S|. Returns (ok, y err, max |y|, state err,
    max |S|)."""
    yo, yr = y.float(), yp.float()
    y_err = float((yo - yr).abs().max())
    y_max = float(yr.abs().max())
    bad = (yo - yr).abs() > K6_Y_RTOL[str(y.dtype)[6:]] * yr.abs() + K6_ATOL_OF_MAX * y_max
    s_err = float((s - sp).abs().max())
    s_max = float(sp.abs().max())
    return not bool(bad.any()) and s_err <= K6_ATOL_OF_MAX * s_max, y_err, y_max, s_err, s_max


def wkv6_inputs(torch, b, t, h, dtype, ww_range, strided, seed, dev):
    """The JAX test's kind of inputs (r, v ~ N(0, 1), k ~ N(0, 1)/2,
    u ~ 0.3·N(0, 1) float32, w = exp(-exp(U(ww_range)))), in ``dtype``;
    ``strided``: views of wider buffers (the head dim contiguous)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = getattr(torch, dtype)
    width = 2 * 64 if strided else 64

    def make(x):
        x = x.to(dt)
        if not strided:
            return x
        buf = torch.zeros((b, t, h, width), dtype=dt, device=dev)
        buf[..., 3:67] = x
        return buf[..., 3:67]

    shape = (b, t, h, 64)
    r = make(torch.randn(shape, generator=g, device=dev))
    k = make(torch.randn(shape, generator=g, device=dev) * 0.5)
    v = make(torch.randn(shape, generator=g, device=dev))
    lo, hi = ww_range
    ww = torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo
    w = make(torch.exp(-torch.exp(ww)))
    u = torch.randn((h, 64), generator=g, device=dev) * 0.3
    return r, k, v, w, u


def phase_wkv6_kernel(torch):
    """K6 against its plain version at every case, then timed at the
    prefill's shape. Returns its dict for the JSON line."""
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda

    dev = torch.device("cuda")
    worst = 0.0
    for i, (name, b, t, h, dtype, ww_range, strided) in enumerate(K6_CASES):
        r, k, v, w, u = wkv6_inputs(torch, b, t, h, dtype, ww_range, strided, 300 + i, dev)
        y, s = ops.wkv6(r, k, v, w, u)
        yp, sp = ops.wkv6_plain(r, k, v, w, u)
        torch.cuda.synchronize()
        check(y.dtype == r.dtype and tuple(y.shape) == (b, t, h, 64), f"wkv6 {name}: y")
        check(s.dtype == torch.float32 and tuple(s.shape) == (b, h, 64, 64), f"wkv6 {name}: state")
        for what, x in (("y", y), ("state", s), ("plain y", yp), ("plain state", sp)):
            check(bool(torch.isfinite(x).all()), f"wkv6 {name}: non-finite {what}")
        ok, y_err, y_max, s_err, s_max = k6_compare(torch, y, s, yp, sp)
        check(ok, f"wkv6 {name}: y max_abs_err {y_err} of {y_max}, "
                  f"state max_abs_err {s_err} of {s_max}")
        say("kernels", kernel="wkv6_fwd", case=repr(name), B=b, T=t, H=h, dtype=dtype,
            ww_range=list(ww_range), strided=strided, y_max_abs_err=y_err,
            y_max_abs=y_max, y_rtol=K6_Y_RTOL[dtype], atol=f"{K6_ATOL_OF_MAX} of max|y|",
            state_max_abs_err=s_err, state_max_abs=s_max,
            state_bitwise_equal=bool(torch.equal(s, sp)))
        worst = max(worst, y_err)

    # ---- timing at the prefill's shape (inputs as the layer leaves them)
    b, t, h = 1, PROMPT, RWKV_HEADS
    r, k, v, w, u = wkv6_inputs(torch, b, t, h, "bfloat16", (-4.0, 0.5), False, 9, dev)
    w_min = ops.w_floor(w.dtype)
    tm = {
        "k6": cuda_ms(lambda i: wkv6_cuda(r, k, v, w, u, w_min=w_min), 400),
        "k6_plain": cuda_ms(lambda i: ops.wkv6_plain(r, k, v, w, u), 5, n_warm=2),
    }
    b6, bound_by, k6_bytes, n_ops = k6_bound(b, t, h, "bfloat16")
    say("timing", kernel="wkv6_fwd", B=b, T=t, H=h, K=64, V=64, dtype="bfloat16",
        ms=tm["k6"], plain_ms=tm["k6_plain"], library_ms=None,
        library="none: no single PyTorch call computes WKV6", bound_ms=b6,
        bytes=k6_bytes, operations=n_ops, share_of_bound=b6 / tm["k6"])
    return {"name": "wkv6_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/wkv6.py:111", "launches": None,
            "on_main_path": True, "max_abs_err": worst, "ms": tm["k6"],
            "plain_ms": tm["k6_plain"], "bound_ms": b6,
            "bound_by": bound_by, "library_ms": None}


# ---- the serving slice: continuous batching of llama3.2-1b ------------ #
SERVE_REQUESTS, SERVE_RATE = 16, 20.0  # the launcher's default rate
# Paged vs dense first-decode-step logits: both run the same bf16 model
# and differ only in the decode attention (K7 keeps the softmax weights in
# float32, the dense path rounds them to bf16 before p·v), an error of a
# few bf16 steps per layer carried through 16 residual layers.
LOGITS_RTOL = 0.05  # of the dense logits' max |value|


def serve_checked(torch, cfg) -> dict:
    """The serving path of a DENSE, MOE, HYBRID or VLM config at full width
    in bf16 on
    the card (random weights from a seed): ContinuousBatchingEngine with
    prefill through K5 (attn_impl "flash") and decode through K7 (attn
    "paged"), after the dense-mode engine on the same trace, and the gates
    of both; then the first decode step of a full slot batch, paged
    against dense, and the wall time per admission and per decode step.
    Returns the run's readings (the model and its parameters, and
    ``first_step``'s, included)."""
    from repro_torch.models import build_model
    from repro_torch.random import TorchDraws
    from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig, TraceConfig,
                                   make_trace)

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trace = make_trace(
        TorchDraws(1, "cpu"),
        TraceConfig(n_requests=SERVE_REQUESTS, rate_per_s=SERVE_RATE, prompt_len=PROMPT,
                    min_gen=4, max_gen=MAX_GEN),
        cfg)
    ecfg = EngineConfig(slots=SLOTS, page_size=PAGE, prompt_len=PROMPT, max_gen=MAX_GEN,
                        max_requests=SERVE_REQUESTS)
    say("serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, vocab=cfg.vocab_size,
        params=model.param_count(), active_params=model.active_param_count(),
        dtype=cfg.param_dtype, init_s=init_s, requests=SERVE_REQUESTS,
        rate_per_s=SERVE_RATE, slots=SLOTS, page=PAGE, prompt=PROMPT,
        gen_len=trace.gen_len.tolist())

    dense = ContinuousBatchingEngine(model, params, ecfg).serve(trace)  # also warms up
    engine = ContinuousBatchingEngine(model, params, dataclasses.replace(ecfg, attn="paged"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    rep = engine.serve(trace)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rep.completed == SERVE_REQUESTS and rep.rejected == 0,
          f"{cfg.name}: {rep.completed} of {SERVE_REQUESTS} requests completed")
    check(dense.completed == SERVE_REQUESTS, f"{cfg.name}: dense engine left requests unserved")
    c = rep.counters
    check(c["arrived"] == c["completed"] + c["rejected"] + c["in_flight"] + c["waiting"],
          f"{cfg.name}: slot conservation: {c}")
    for r in (rep, dense):
        for req in range(SERVE_REQUESTS):
            toks = r.tokens_for(req)
            check(len(toks) == int(trace.gen_len[req]), f"request {req}: {len(toks)} tokens")
            check(all(0 <= x < cfg.vocab_size for x in toks), f"request {req}: token out of range")
    expect_launches(launches, flash_attention_fwd=cfg.num_layers * rep.prefills,
                    paged_attention_fwd=cfg.num_layers * rep.decode_steps,
                    fedavg_apply=0, delta_sq_norms=0, delta_pipeline_apply=0,
                    delta_pipeline_partial=0, wkv6_fwd=0)
    same = sum(rep.tokens_for(i) == dense.tokens_for(i) for i in range(SERVE_REQUESTS))
    # Both engines prefill through the same K5 path: their first tokens agree.
    check(all(rep.tokens_for(i)[0] == dense.tokens_for(i)[0] for i in range(SERVE_REQUESTS)),
          f"{cfg.name}: paged and dense engines differ in a prefill token")

    # First decode step of a full slot batch, paged vs dense, on one pool;
    # then wall time per admission and per decode step (these launches
    # are outside the counted run).
    embeds = None
    if trace.patch_embeds is not None:
        embeds = torch.from_numpy(trace.patch_embeds[:SLOTS]).cuda().to(
            getattr(torch, cfg.compute_dtype))
    fs = first_step(torch, cfg, model, params, torch.from_numpy(trace.prompts[:SLOTS]).cuda(),
                    embeds)
    say("serve", arch=cfg.name, engine="continuous", attn="paged", attn_impl=cfg.attn_impl,
        completed=rep.completed, rejected=rep.rejected, prefills=rep.prefills,
        decode_steps=rep.decode_steps, tokens=rep.tokens_generated, counters=c,
        launches=launches, wall_s=rep.wall_s, tokens_per_wall_s=rep.tokens_per_wall_s,
        virtual_ms=rep.virtual_ms, p50_ms=rep.percentiles["p50"], peak_bytes=peak)
    say("serve", arch=cfg.name, dense_wall_s=dense.wall_s,
        dense_decode_steps=dense.decode_steps,
        share_of_requests_with_dense_tokens=same / SERVE_REQUESTS,
        first_step_logits_max_abs_diff_to_dense_f32_attention=fs["diff"],
        dense_f32_attention_logits_max_abs=fs["scale"], tol=f"{LOGITS_RTOL} x max|dense f32|",
        same_next_token_as_dense_f32_attention=f"{fs['same_next_token']} of {SLOTS}",
        wall_ms_per_admission=fs["admit_ms"], wall_ms_per_decode_step=fs["decode_ms"],
        first_request_tokens=rep.tokens_for(0))
    return dict(fs, model=model, params=params, trace=trace, launches=launches, rep=rep,
                peak=peak, init_s=init_s)


def phase_serving(torch):
    """The port's serving path: ContinuousBatchingEngine for full-width
    llama3.2-1b in bf16 on the card, prefill through K5 (attn_impl
    "flash") and decode through K7 (attn "paged"), after the dense-mode
    engine on the same trace. Returns the paged run's launch counts."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3.2-1b"), attn_impl="flash")
    return serve_checked(torch, cfg)["launches"]


# ---- the rwkv6 serving slice: continuous batching, prefill through K6 -- #
# K6 vs its plain version in the full prefill of the 16 prompts, against
# the float32 prefill of the same (bf16-valued) weights on the plain version:
#   * float32 model: K6 and the plain version differ only in the order of
#     y's sums and in the products by which each decay is formed (~1e-6
#     relative), carried through 24 layers; held to RWKV_F32_RTOL of the
#     float32 logits' max |value|;
#   * bf16 model (the served one): the two round y once each to bf16 and
#     may land a bf16 step apart, a difference the 24 layers' residual
#     stream and bf16 GEMMs amplify (9.4 % of max |logit| between them in
#     the first full run), so the logits cannot hold a wrong kernel to
#     account. Each layer's K6 call in the bf16 prefill is held instead
#     against the plain version on that layer's own inputs, as phase 3
#     holds K6 (``k6_compare``). The bf16 logits are also held to no more
#     than RWKV_BF16_FACTOR times the plain bf16 prefill's own distance from
#     the float32 logits, a loose check that rounding alone passes; the
#     share of max |logit| between the two is printed.
RWKV_F32_RTOL = 1e-3
RWKV_BF16_FACTOR = 2.0


@contextlib.contextmanager
def plain_wkv6():
    """Run the model's prefill on K6's plain version: the reference the
    kernel's prefill is held against (launches K6 never)."""
    from repro_torch.kernels.wkv6 import ops

    kernel = ops.wkv6
    ops.wkv6 = ops.wkv6_plain
    try:
        yield
    finally:
        ops.wkv6 = kernel


@contextlib.contextmanager
def wkv6_held_against_plain(torch, records):
    """Run every K6 call of the model against the plain version on the same
    inputs, appending ``k6_compare``'s result to ``records``."""
    from repro_torch.kernels.wkv6 import ops

    kernel = ops.wkv6

    def held(r, k, v, w, u):
        y, s = kernel(r, k, v, w, u)
        yp, sp = ops.wkv6_plain(r, k, v, w, u)
        records.append(k6_compare(torch, y, s, yp, sp))
        return y, s

    ops.wkv6 = held
    try:
        yield
    finally:
        ops.wkv6 = kernel


def phase_serving_rwkv6(torch):
    """The port's rwkv6 serving path: ContinuousBatchingEngine for
    full-width rwkv6-1.6b in bf16 on the card, prefill through K6, decode
    through the plain one-token recurrence. Returns the counted run's
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.random import TorchDraws
    from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig, TraceConfig,
                                   make_trace, paged)

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = get_config("rwkv6-1.6b")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trace = make_trace(
        TorchDraws(1, "cpu"),
        TraceConfig(n_requests=SERVE_REQUESTS, rate_per_s=SERVE_RATE, prompt_len=PROMPT,
                    min_gen=4, max_gen=MAX_GEN),
        cfg)
    ecfg = EngineConfig(slots=SLOTS, page_size=PAGE, prompt_len=PROMPT, max_gen=MAX_GEN,
                        max_requests=SERVE_REQUESTS)
    say("serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        wkv_heads=cfg.d_model // 64, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        params=model.param_count(), dtype=cfg.param_dtype, init_s=init_s,
        requests=SERVE_REQUESTS, rate_per_s=SERVE_RATE, slots=SLOTS, prompt=PROMPT,
        gen_len=trace.gen_len.tolist())

    engine = ContinuousBatchingEngine(model, params, ecfg)
    warm = engine.serve(trace)  # warm-up: cuBLAS handles, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    rep = engine.serve(trace)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rep.completed == SERVE_REQUESTS and rep.rejected == 0,
          f"{rep.completed} of {SERVE_REQUESTS} requests completed")
    c = rep.counters
    check(c["arrived"] == c["completed"] + c["rejected"] + c["in_flight"] + c["waiting"],
          f"slot conservation: {c}")
    for req in range(SERVE_REQUESTS):
        toks = rep.tokens_for(req)
        check(len(toks) == int(trace.gen_len[req]), f"request {req}: {len(toks)} tokens")
        check(all(0 <= x < cfg.vocab_size for x in toks), f"request {req}: token out of range")
    check(rep.prefills == SERVE_REQUESTS, f"{rep.prefills} admissions")
    expect_launches(launches, wkv6_fwd=cfg.num_layers * rep.prefills, fedavg_apply=0,
                    delta_sq_norms=0, delta_pipeline_apply=0, delta_pipeline_partial=0,
                    flash_attention_fwd=0, paged_attention_fwd=0)
    repeat = sum(rep.tokens_for(i) == warm.tokens_for(i) for i in range(SERVE_REQUESTS))

    # The 16 prompts' prefill in one batch through K6 and through its plain
    # version, in bf16 and in float32 (launches outside the counted run).
    prompts = torch.from_numpy(trace.prompts).to(dev)
    layers = []
    with wkv6_held_against_plain(torch, layers):
        logits_k6, cache_k6 = model.prefill(params, {"tokens": prompts}, cache_len=0)
    with plain_wkv6():
        logits_plain, cache_plain = model.prefill(params, {"tokens": prompts}, cache_len=0)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params32 = {k: ({n: x.float() for n, x in v.items()} if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    model32 = build_model(cfg32)
    logits32_k6, _ = model32.prefill(params32, {"tokens": prompts}, cache_len=0)
    with plain_wkv6():
        logits32, _ = model32.prefill(params32, {"tokens": prompts}, cache_len=0)
    del params32
    torch.cuda.synchronize()
    check(len(layers) == cfg.num_layers, f"{len(layers)} K6 calls in the bf16 prefill")
    for i, (ok, y_err, y_max, s_err, s_max) in enumerate(layers):
        check(ok, f"K6 in layer {i} of the bf16 prefill: y max_abs_err {y_err} of {y_max}, "
                  f"state max_abs_err {s_err} of {s_max}")
    for name, x in (("bf16", logits_k6), ("float32", logits32_k6)):
        check(bool(torch.isfinite(x).all()), f"K6 {name} prefill: non-finite logits")
    scale32 = float(logits32.abs().max())
    diff32 = float((logits32_k6 - logits32).abs().max())
    check(diff32 <= RWKV_F32_RTOL * scale32,
          f"float32 K6 vs plain prefill logits: {diff32} > {RWKV_F32_RTOL} x {scale32}")
    err_k6 = float((logits_k6 - logits32).abs().max())
    err_plain = float((logits_plain - logits32).abs().max())
    check(err_k6 <= RWKV_BF16_FACTOR * err_plain,
          f"bf16 K6 prefill {err_k6} from float32, plain {err_plain}")
    diff = float((logits_k6 - logits_plain).abs().max())
    scale = float(logits_plain.abs().max())
    diff0 = float((logits_k6[0] - logits_plain[0]).abs().max())
    scale0 = float(logits_plain[0].abs().max())
    state_diff = float((cache_k6["wkv"] - cache_plain["wkv"]).abs().max())
    state_max = float(cache_plain["wkv"].abs().max())
    first_k6 = torch.argmax(logits_k6[:, -1], dim=-1).tolist()
    first_plain = torch.argmax(logits_plain[:, -1], dim=-1).tolist()
    same_first = sum(a == b for a, b in zip(first_k6, first_plain))
    engine_first = sum(rep.tokens_for(i)[0] == first_plain[i] for i in range(SERVE_REQUESTS))

    # Wall time per admission (8 slots) and per decode step (20 steps over
    # the full slot batch); then every slot's state must be finite.
    plan = engine.plan
    pool = paged.init_pool(cfg, plan, SLOTS, engine.num_pages, device=dev)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    out_buf = torch.zeros((SERVE_REQUESTS + 1, MAX_GEN), dtype=torch.int32, device=dev)
    admit = paged.make_admit_fn(model, plan)
    no_pages = torch.zeros((plan.prompt_pages,), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for slot in range(SLOTS):
        admit(params, pool, tokens, out_buf, prompts[slot:slot + 1], no_pages, slot, slot)
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t0) / SLOTS * 1e3
    step = paged.make_decode_fn(model, plan)
    table = torch.zeros((SLOTS, plan.pages_per_slot), dtype=torch.int32, device=dev)
    positions = torch.full((SLOTS,), plan.prompt_eff, dtype=torch.int64, device=dev)
    active = torch.ones((SLOTS,), dtype=torch.bool, device=dev)
    out_req = torch.full((SLOTS,), SERVE_REQUESTS, dtype=torch.int64, device=dev)
    out_idx = torch.zeros((SLOTS,), dtype=torch.int64, device=dev)
    n_steps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        pool, tokens, out_buf = step(params, pool, tokens, out_buf, table, positions + i,
                                     active, out_req, out_idx)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / n_steps * 1e3
    for key, x in pool.items():
        check(bool(torch.isfinite(x).all()), f"slot state {key} not finite")
    say("serve", arch=cfg.name, engine="continuous", completed=rep.completed,
        rejected=rep.rejected, prefills=rep.prefills, decode_steps=rep.decode_steps,
        tokens=rep.tokens_generated, counters=c, launches=launches, wall_s=rep.wall_s,
        tokens_per_wall_s=rep.tokens_per_wall_s, virtual_ms=rep.virtual_ms,
        p50_ms=rep.percentiles["p50"], peak_bytes=peak,
        requests_with_the_warm_up_run_tokens=repeat)
    say("serve", arch=cfg.name, float32_prefill_logits_max_abs_diff_k6_vs_plain=diff32,
        float32_logits_max_abs=scale32, float32_tol=f"{RWKV_F32_RTOL} x max|float32|",
        bf16_k6_max_abs_err_vs_float32=err_k6, bf16_plain_max_abs_err_vs_float32=err_plain,
        bf16_tol=f"{RWKV_BF16_FACTOR} x the plain version's",
        bf16_layers_held=len(layers),
        bf16_layers_worst_y_max_abs_err=max(x[1] for x in layers),
        bf16_layers_worst_state_share=max(x[3] / x[4] for x in layers),
        bf16_prefill_logits_max_abs_diff_k6_vs_plain=diff, bf16_plain_logits_max_abs=scale,
        share=diff / scale, first_prompt_share=diff0 / scale0,
        prefill_state_max_abs_diff=state_diff, prefill_state_max_abs=state_max,
        share_of_first_tokens_equal_k6_vs_plain_batched=same_first / SERVE_REQUESTS,
        share_of_engine_first_tokens_equal_to_plain=engine_first / SERVE_REQUESTS,
        wall_ms_per_admission=admit_ms, wall_ms_per_decode_step=decode_ms,
        slot_states_finite=True, first_request_tokens=rep.tokens_for(0))
    return launches


def run_slice(torch, sim_mod, rounds, tap=None, **overrides):
    """Drive a main path of the port: build the simulator, set the launch
    counts to 0, run ``run_scanned()``, read the counts. Returns (history,
    {kernel: launches}, init seconds, run seconds, peak bytes)."""
    cfg = sim_mod.SimulatorConfig(rounds=rounds, use_pallas_agg=True, **overrides)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = sim_mod.FedFogSimulator(cfg, device="cuda", tap=tap)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    hist = sim.run_scanned()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    expect_launches(launches, fedavg_apply=0, flash_attention_fwd=0, wkv6_fwd=0,
                    paged_attention_fwd=0)
    for k, v in hist.items():
        vals = v if isinstance(v, list) else [v]
        check(all(math.isfinite(x) for x in vals), f"metric {k} not finite")
    return hist, launches, init_s, seconds, torch.cuda.max_memory_allocated()


def expect_launches(launches, **want):
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times, not {n}")


# ---- the robustness path: Table V's attacks, HAR, faults, a tap ------- #
# benchmarks/robustness.py's Table V settings (name, attack, fraction).
TABLE_V = (("clean", "none", 0.0), ("label_flip", "label_flip", 0.20),
           ("noise", "noise", 0.20), ("dropout", "dropout", 0.20),
           ("model_replacement", "model_replacement", 0.05))
# The JAX package's own accuracy bar for HAR (tests/test_fl_integration.py).
HAR_MIN_ACCURACY = 0.3
# benchmarks/robustness_faults.py's storm.
STORM = dict(crash_rate=0.5, max_retries=2, backoff_base_ms=500.0)


def check_conservation(hist, name) -> None:
    """dispatched == completed + terminal + lost, in every round."""
    for r, d in enumerate(hist["fault_dispatched"]):
        rest = (hist["fault_completed"][r] + hist["fault_terminal"][r]
                + hist["fault_lost"][r])
        check(d == rest, f"{name}: round {r} dispatched {d} != {rest}")


def count_syncs(torch, fn) -> int:
    """Synchronising CUDA calls made by ``fn()``, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (``fn`` ends
    with its own device-to-host copy; nothing else runs in the window)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_robustness(torch, sim_mod, smi) -> dict:
    """The simulator's robustness path (benchmarks/robustness.py and
    robustness_faults.py) at the dense configuration: Table V's attacks
    (K3's mean route, then its robust route under median and trimmed),
    HAR dense (K3) and at population 10^6 with four fogs (K4), the fault
    runs (K3 and, at two and four fogs, K4 on blocks of dark fogs), the
    quorum carry-over, the host synchronisations with and without faults
    and an attack, and a tapped run. Returns {kernel: launches} summed over
    its counted runs, and K3's on the robust route."""
    from repro_torch.obs import MemoryTracker, MetricTap
    from repro_torch.sim.faults import FaultConfig

    totals = {name: 0 for name in kernel_counters()}
    totals["robust_kernel"] = 0
    none = dict(delta_sq_norms=0, fedavg_apply=0)

    def run(name, rounds, want, **over):
        h, ln, _, sec, _ = run_slice(torch, sim_mod, rounds, **over)
        robust = want["delta_pipeline_apply"] if over.get("aggregator") in (
            "median", "trimmed") else 0
        expect_launches(ln, **none, robust_kernel=robust, **want)
        for k, v in ln.items():
            totals[k] += v
        if over.get("faults") is not None:
            check_conservation(h, name)
        ms = sec / rounds * 1e3
        return h, ms

    k3_only = dict(delta_pipeline_apply=20, delta_pipeline_partial=0)
    # Table V under Eq. 6 FedAvg, then the two delta attacks under the
    # robust aggregators (robust_kernel).
    finals = {}
    for name, attack, frac in TABLE_V:
        h, ms = run(name, 20, k3_only, attack=attack, attack_fraction=frac)
        finals[name] = h["final_accuracy"]
        say("robustness", run=f"tableV/{name}", aggregator="fedavg", rounds=20,
            final_accuracy=h["final_accuracy"], ms_per_round=ms, card=repr(smi))
    drops = {k: finals["clean"] - v for k, v in finals.items() if k != "clean"}
    say("robustness", run="tableV/summary", clean=finals["clean"],
        severity_order=">".join(sorted(drops, key=lambda k: -drops[k])),
        **{f"drop_{k}": v for k, v in drops.items()})
    for agg in ("median", "trimmed"):
        for name, attack, frac in TABLE_V[2::2]:
            h, ms = run(name, 20, k3_only, attack=attack, attack_fraction=frac,
                        aggregator=agg)
            say("robustness", run=f"tableV/{name}", aggregator=agg, rounds=20,
                final_accuracy=h["final_accuracy"], ms_per_round=ms, card=repr(smi))

    # HAR: dense through K3, then at population 10^6 with four fogs (K4).
    h, ms = run("har", 20, k3_only, task="har")
    say("robustness", run="har/dense", rounds=20, final_accuracy=h["final_accuracy"],
        accuracy=[round(a, 4) for a in h["accuracy"]], ms_per_round=ms, card=repr(smi))
    check(h["final_accuracy"] > HAR_MIN_ACCURACY,
          f"HAR final accuracy {h['final_accuracy']} <= {HAR_MIN_ACCURACY}")
    h, ms = run("har/pop", 3, dict(delta_pipeline_partial=12, delta_pipeline_apply=0),
                task="har", **POP_FOG)
    say("robustness", run="har/population+fog", rounds=3, fog_nodes=4,
        accuracy=[round(a, 4) for a in h["accuracy"]], ms_per_round=ms, card=repr(smi))

    # Faults, as benchmarks/robustness_faults.py sets them.
    fault_runs = (
        ("crash_0.2", dict(faults=FaultConfig(crash_rate=0.2, max_retries=2)), k3_only),
        ("crash_0.5", dict(faults=FaultConfig(crash_rate=0.5, max_retries=2)), k3_only),
        ("storm/barrier", dict(faults=FaultConfig(**STORM)), k3_only),
        ("storm/deadline", dict(faults=FaultConfig(**STORM, deadline_ms=4000.0,
                                                    quorum_frac=0.25)), k3_only),
        ("outage/2fogs", dict(fog_nodes=2, faults=FaultConfig(fog_outage_rate=0.3)),
         dict(delta_pipeline_partial=40, delta_pipeline_apply=0)),
        ("outage/2fogs/failover", dict(fog_nodes=2, faults=FaultConfig(
            fog_outage_rate=0.3, fog_failover=True)),
         dict(delta_pipeline_partial=40, delta_pipeline_apply=0)),
        ("outage/pop+fog", dict(POP_FOG, faults=FaultConfig(fog_outage_rate=0.3)),
         dict(delta_pipeline_partial=80, delta_pipeline_apply=0)),
        ("outage/pop+fog/failover", dict(POP_FOG, faults=FaultConfig(
            fog_outage_rate=0.3, fog_failover=True)),
         dict(delta_pipeline_partial=80, delta_pipeline_apply=0)),
    )
    for name, over, want in fault_runs:
        h, ms = run(name, 20, want, **over)
        sums = {k: sum(h[k]) for k in ("fault_dispatched", "fault_completed",
                                        "fault_terminal", "fault_lost", "fault_retries",
                                        "fog_outages", "fault_failed_over",
                                        "round_skipped")}
        say("robustness", run=f"faults/{name}", rounds=20,
            final_accuracy=h["final_accuracy"], mean_latency_ms=h["mean_latency_ms"],
            ms_per_round=ms, card=repr(smi), conserved=True, **sums)
        fc = over["faults"]
        if fc.crash_rate > 0:
            check(sums["fault_retries"] > 0, f"{name}: no retries")
        if fc.fog_outage_rate > 0 and not fc.fog_failover:
            check(sums["fault_lost"] > 0, f"{name}: an outage without failover lost nothing")
        if fc.fog_failover:
            check(sums["fault_lost"] == 0 and sums["fault_failed_over"] > 0,
                  f"{name}: failover lost {sums['fault_lost']}, rerouted "
                  f"{sums['fault_failed_over']}")

    # Below quorum every round is skipped and the model carries over bitwise.
    sim = sim_mod.FedFogSimulator(sim_mod.SimulatorConfig(
        rounds=3, use_pallas_agg=True,
        faults=FaultConfig(crash_rate=1.0, quorum_frac=0.5)), device="cuda")
    before = [{k: v.clone() for k, v in layer.items()} for layer in sim.params]
    zero_counts()
    h = sim.run_scanned()
    ln = read_counts()
    expect_launches(ln, **none, delta_pipeline_apply=3, delta_pipeline_partial=0,
                    robust_kernel=0)
    for k, v in ln.items():
        totals[k] += v
    check_conservation(h, "quorum")
    same = all(torch.equal(a[k], b[k]) for a, b in zip(before, sim.params) for k in a)
    check(same, "a skipped round changed the parameters")
    check(all(s == float(d > 0) for s, d in zip(h["round_skipped"], h["fault_dispatched"]))
          and sum(h["fault_dispatched"]) > 0, "a dispatching round was not skipped")
    say("robustness", run="faults/quorum_skip", rounds=3, params_bitwise_equal=same,
        round_skipped=h["round_skipped"], fault_dispatched=h["fault_dispatched"])

    # Host synchronisations of a 3-round run_scanned(), each counted after
    # an identical warm-up run (launches outside the counted runs): the
    # dense round makes none, with or without faults and an attack, and
    # under int8 or top-k compression, so the run makes one, its final
    # stacked copy; the population + fog run's count is reported beside
    # them.
    def syncs(**over):
        cfg = sim_mod.SimulatorConfig(rounds=3, use_pallas_agg=True, **over)
        sim_mod.FedFogSimulator(cfg, device="cuda").run_scanned()
        sim = sim_mod.FedFogSimulator(cfg, device="cuda")
        torch.cuda.synchronize()
        return count_syncs(torch, sim.run_scanned)

    # The first window of a process reports one synchronisation that no
    # later window does; open it on a single copy before the two counts.
    first = count_syncs(torch, lambda: torch.zeros(1, device="cuda").cpu())
    plain_syncs = syncs()
    faulted_syncs = syncs(faults=FaultConfig(crash_rate=0.5, max_retries=2),
                          attack="noise", attack_fraction=0.20)
    int8_syncs = syncs(compression="int8")
    topk_syncs = syncs(compression="topk")
    pop_syncs = syncs(**POP_FOG)
    say("robustness", run="sync_count", rounds=3, plain=plain_syncs,
        faults_and_noise_attack=faulted_syncs, int8=int8_syncs, topk=topk_syncs,
        population_fog=pop_syncs, first_window_one_copy=first)
    check(plain_syncs == faulted_syncs == int8_syncs == topk_syncs == 1,
          f"host synchronisations of 3 dense rounds: {faulted_syncs} with faults and an "
          f"attack, {int8_syncs} under int8, {topk_syncs} under top-k, {plain_syncs} "
          "without; 1 expected (the final copy)")

    # A tap: its rows equal the history at rounds 0, 5, 10, 15, and the
    # history equals the untapped run's bitwise.
    h0, ms0 = run("untapped", 20, k3_only)
    tracker = MemoryTracker()
    tap = MetricTap(tracker, every=5)
    h1, ms1 = run("tapped", 20, k3_only, tap=tap)
    check(h1 == h0, "the tapped history differs from the untapped one")
    check([r["step"] for r in tracker.rows] == [0, 5, 10, 15], "tap rows at the wrong steps")
    for row in tracker.rows:
        for k, v in row.items():
            if k not in ("event", "step"):
                check(v == h1[k][row["step"]], f"tap row {row['step']} {k}: {v}")
    check(len(tracker.summaries) == 1, "no tap summary")
    say("robustness", run="tap", rounds=20, every=5, rows=len(tracker.rows),
        ms_per_round_untapped=ms0, ms_per_round_tapped=ms1, card=repr(smi))
    return totals


# ---- the asynchronous event engine and the sweep ----------------------- #
# 20 dispatches at the dense configuration's full width (64 clients, the
# 112,766-parameter MLP); the bitwise loop comparisons at 5.
ASYNC_DISPATCHES = 20
ASYNC_ORACLE_DISPATCHES = 5
ASYNC_FAULTS = dict(crash_rate=0.3, max_retries=2, deadline_ms=6000.0)
ASYNC_CHURN = dict(arrival_rate=0.2, departure_rate=0.1)


def async_configs(ev_mod, faults_mod):
    """(name, SimulatorConfig overrides, AsyncConfig, expected launches as
    {kernel: flushes multiplier}) of the async phase's runs (a)-(f)."""
    A, K3, K4 = ev_mod.AsyncConfig, "delta_pipeline_apply", "delta_pipeline_partial"
    return (
        ("a/cohort", {}, A(), {K3: 1}),
        ("b/fedasync", {}, A.fedasync(straggler_sigma=0.5), {K3: 1}),
        ("c/fedbuff8+4fogs", dict(fog_nodes=4), A.fedbuff(8), {K4: 4}),
        ("d/fedbuff8+median+noise", dict(aggregator="median", attack="noise",
                                          attack_fraction=0.20), A.fedbuff(8),
         {K3: 1, "robust_kernel": 1}),
        ("e/fedbuff8+churn+faults", dict(faults=faults_mod.FaultConfig(**ASYNC_FAULTS)),
         A.fedbuff(8, churn=ev_mod.ChurnConfig(**ASYNC_CHURN)), {K3: 1}),
        ("f/fedbuff8+population+4fogs", dict(POP_FOG), A.fedbuff(8), {K4: 4}),
    )


def async_run(torch, sim_mod, ev_mod, dispatches, acfg, **over):
    """One event-loop run on the card, launch counts set to 0 just before
    the loop and read just after. Returns (sim, final state, history,
    launches, loop seconds)."""
    import warnings

    cfg = sim_mod.SimulatorConfig(rounds=dispatches, use_pallas_agg=True, **over)
    sim = ev_mod.AsyncFedFogSimulator(cfg, acfg, device="cuda")
    state = sim.init_state(cfg.seed)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    final = sim._scan_events(state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # churn losses are expected
        hist = sim.history(final)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    expect_launches(launches, fedavg_apply=0, delta_sq_norms=0, flash_attention_fwd=0,
                    wkv6_fwd=0, paged_attention_fwd=0)
    for k, v in hist.items():
        vals = v if isinstance(v, list) else [v]
        check(all(math.isfinite(x) for x in vals), f"async metric {k} not finite")
    return sim, final, hist, launches, seconds


def same_final(torch, a, b) -> bool:
    """Two final states equal bit for bit: flush channels, counters,
    parameters."""
    same = all(torch.equal(a.m_flush[k], b.m_flush[k]) for k in a.m_flush)
    for k in ("completions", "lost_inflight", "fault_retries", "fault_terminal",
              "fault_lost_deadline", "fault_failures", "t_ms"):
        same = same and torch.equal(getattr(a, k), getattr(b, k))
    same = same and all(torch.equal(x[k], y[k]) for x, y in zip(a.params, b.params)
                        for k in x)
    return same and a.flush_idx == b.flush_idx


def phase_async(torch, sim_mod, smi) -> dict:
    """The event engine (``sim.events``) at the dense configuration's full
    width: cohort mode against the port's run_scanned(), FedAsync, FedBuff
    at four fogs (K4), under median (robust_kernel), with churn and faults,
    and at population 10^6 with four fogs; launches against flushes,
    updates conserved, no queue drop, the loops bit for bit, the host
    synchronisations per coalesced step. Returns the launches summed."""
    import dataclasses as dc

    from repro_torch.sim import events as ev_mod
    from repro_torch.sim import faults as faults_mod

    totals = {name: 0 for name in kernel_counters()}
    totals["robust_kernel"] = 0
    for name, over, acfg, want in async_configs(ev_mod, faults_mod):
        sim, final, h, ln, sec = async_run(torch, sim_mod, ev_mod, ASYNC_DISPATCHES, acfg,
                                           **over)
        for k, v in ln.items():
            totals[k] += v
        n_f, n_d = h["num_flushes"], h["num_dispatches"]
        check(n_f > 0 and n_d == ASYNC_DISPATCHES, f"{name}: {n_d} dispatches, {n_f} flushes")
        full = {k: m * n_f for k, m in want.items()}
        full.setdefault("delta_pipeline_apply", 0)
        full.setdefault("delta_pipeline_partial", 0)
        full.setdefault("robust_kernel", 0)
        expect_launches(ln, **full)
        check(int(final.queue.dropped) == 0, f"{name}: the queue dropped events")
        admitted = int(sum(h["dispatch_num_admitted"]))
        busy, buffered = int(final.busy.sum()), int(final.buf.sum())
        lost = h["lost_inflight"] + h["fault_lost_deadline"]
        check(admitted == h["num_completions"] + h["fault_terminal"] + lost + busy,
              f"{name}: admitted {admitted} != completions {h['num_completions']} + "
              f"terminal {h['fault_terminal']} + lost {lost} + in flight {busy}")
        if over.get("faults") is None:
            check(h["num_completions"] == sum(h["num_aggregated"]) + buffered,
                  f"{name}: completions {h['num_completions']} != aggregated "
                  f"{sum(h['num_aggregated'])} + buffered {buffered}")
        say("async", run=name, dispatches=n_d, flushes=n_f, steps=sim.steps,
            admitted=admitted, completions=h["num_completions"],
            lost_inflight=h["lost_inflight"], terminal=h["fault_terminal"],
            lost_deadline=h["fault_lost_deadline"], retries=h["fault_retries"],
            in_flight=busy, buffered=buffered, conserved=True, launches={
                k: v for k, v in ln.items() if v},
            max_mean_staleness=max(h["mean_staleness"]),
            final_accuracy=h["final_accuracy"], virtual_ms=h["virtual_time_ms"],
            wall_ms_per_dispatch=sec / n_d * 1e3, wall_ms_per_flush=sec / n_f * 1e3,
            card=repr(smi))
        if name.startswith("a/"):
            # Sync recovery: the port's own synchronous rounds on the same
            # keyed draws (not counted: a sync run).
            hs = sim_mod.FedFogSimulator(
                sim_mod.SimulatorConfig(rounds=ASYNC_DISPATCHES, use_pallas_agg=True),
                device="cuda").run_scanned()
            acc_diff = max(abs(a - b) for a, b in zip(h["accuracy"], hs["accuracy"]))
            check(n_f == ASYNC_DISPATCHES and acc_diff <= 2 / 512,
                  f"cohort mode vs run_scanned: accuracy differs by {acc_diff}")
            check(h["cold_starts"] == hs["cold_starts"]
                  and h["num_aggregated"] == hs["num_selected"],
                  "cohort mode vs run_scanned: cold starts or selections differ")
            for x, y, what in ((h["update_latency_ms"], hs["round_latency_ms"], "latency"),
                               (h["energy_j"], hs["energy_j"], "energy")):
                check(all(abs(a - b) <= 1e-5 * abs(b) + 1e-3 for a, b in zip(x, y)),
                      f"cohort mode vs run_scanned: {what} differs")
            say("async", run="a/cohort_vs_run_scanned", accuracy_max_abs_diff=acc_diff,
                bitwise_accuracy=h["accuracy"] == hs["accuracy"])
        if name.startswith("b/"):
            check(max(h["mean_staleness"]) > 0, "fedasync: no stale update aggregated")
    # The coalesced loop against the single-pop loop, at 5 dispatches.
    for name, over, acfg, _ in async_configs(ev_mod, faults_mod):
        if name[0] not in "be":
            continue
        runs = []
        for coalesce in (True, False):
            sim, final, h, ln, sec = async_run(
                torch, sim_mod, ev_mod, ASYNC_ORACLE_DISPATCHES,
                dc.replace(acfg, coalesce=coalesce), **over)
            for k, v in ln.items():
                totals[k] += v
            runs.append((sim.steps, final, sec))
        same = same_final(torch, runs[0][1], runs[1][1])
        check(same, f"{name}: the coalesced loop differs from the single-pop loop")
        say("async", run=f"{name}/coalesced_vs_single_pop", dispatches=ASYNC_ORACLE_DISPATCHES,
            bitwise_equal=same, coalesced_steps=runs[0][0], single_pop_steps=runs[1][0],
            coalesced_s=runs[0][2], single_pop_s=runs[1][2])
    # Host synchronisations per coalesced step (5 dispatches each).
    for name, over, acfg, _ in async_configs(ev_mod, faults_mod):
        if name[0] not in "abe":
            continue
        cfg = sim_mod.SimulatorConfig(rounds=ASYNC_ORACLE_DISPATCHES, use_pallas_agg=True,
                                      **over)
        sim = ev_mod.AsyncFedFogSimulator(cfg, acfg, device="cuda")
        state = sim.init_state(cfg.seed)
        torch.cuda.synchronize()
        out = {}
        n = count_syncs(torch, lambda: out.setdefault("f", sim._scan_events(state)))
        f = out["f"]
        # At most two a step, and one more for the check that finds the
        # queue empty.
        check(n <= 2 * sim.steps + 1,
              f"{name}: {n} synchronisations in {sim.steps} steps")
        say("async", run=f"{name}/sync_count", dispatches=ASYNC_ORACLE_DISPATCHES,
            steps=sim.steps, flushes=f.flush_idx, syncs=n, syncs_per_step=n / sim.steps,
            syncs_per_flush=n / max(f.flush_idx, 1))
    return totals


SWEEP_AXES = {"policy": ["fedfog", "rcs", "fogfaas", "vanilla"], "lr": [0.05, 0.1]}
SWEEP_ROUNDS = 10
SWEEP_SEEDS = (0, 1, 2)


def phase_sweep(torch, sim_mod, smi) -> dict:
    """run_sweep over both engines at the dense configuration: the policy ×
    lr grid over three seeds, 10 rounds; seed 1 of two points equal to its
    standalone run, group=False equal to group=True, aot_scanned /
    run_scanned_with equal to run_scanned() on a peer of another seed; one
    async fedbuff(8) sweep of two seeds, its seed 1 equal to the standalone
    engine's. Returns the launches summed."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.sim import events as ev_mod
    from repro_torch.sim import run_sweep

    totals = {name: 0 for name in kernel_counters()}
    totals["robust_kernel"] = 0
    cfg = sim_mod.SimulatorConfig(rounds=SWEEP_ROUNDS, use_pallas_agg=True)

    def sweep(**kw):
        torch.cuda.synchronize()
        zero_counts()
        tm = {}
        t0 = time.perf_counter()
        res = run_sweep(cfg, seeds=SWEEP_SEEDS[:kw.pop("n_seeds", 3)], device="cuda",
                        timings=tm, **kw)
        sec = time.perf_counter() - t0
        ln = read_counts()
        for k, v in ln.items():
            totals[k] += v
        return res, ln, sec, tm

    res, ln, sec, tm = sweep(axes=SWEEP_AXES)
    runs = len(res.configs) * len(res.seeds)
    expect_launches(ln, delta_pipeline_apply=runs * SWEEP_ROUNDS, delta_pipeline_partial=0,
                    delta_sq_norms=0, fedavg_apply=0)
    check(all(np.isfinite(v).all() for v in res.history.values()), "sweep: not finite")
    say("sweep", engine="scan", points=len(res.configs), seeds=len(res.seeds),
        rounds=SWEEP_ROUNDS, groups=tm["n_groups"], k3_launches=ln["delta_pipeline_apply"],
        wall_s=sec, wall_s_per_point_seed=sec / runs,
        final_accuracy_mean=[round(float(x), 4) for x in res.final("accuracy").mean(1)],
        card=repr(smi))
    for g in (0, 5):
        h = sim_mod.FedFogSimulator(dc.replace(cfg, seed=1, **res.configs[g]),
                                    device="cuda").run_scanned()
        same = all(np.array_equal(res.history[k][g, 1], np.asarray(h[k]))
                   for k in res.history)
        check(same, f"sweep point {res.configs[g]} seed 1 differs from its standalone run")
        say("sweep", check=f"seed 1 of {res.configs[g]} == standalone run_scanned()",
            bitwise_equal=same)
    flat, _, sec_flat, _ = sweep(axes=SWEEP_AXES, group=False)
    same = all(np.array_equal(res.history[k], flat.history[k]) for k in res.history)
    check(same, "sweep: group=False differs from group=True")
    say("sweep", check="group=False == group=True", bitwise_equal=same, ungrouped_wall_s=sec_flat)
    prog = sim_mod.FedFogSimulator(cfg, device="cuda", defer_state=True).aot_scanned()
    for s in (0, 1):
        c = dc.replace(cfg, seed=s)
        a = sim_mod.FedFogSimulator(c, device="cuda").run_scanned_with(prog)
        b = sim_mod.FedFogSimulator(c, device="cuda").run_scanned()
        check(a == b, f"run_scanned_with differs from run_scanned() at seed {s}")
        say("sweep", check=f"aot_scanned (seed 0) + run_scanned_with (seed {s}) == "
            "run_scanned()", bitwise_equal=True)
    acfg = ev_mod.AsyncConfig.fedbuff(8)
    ares, ln, sec, tm = sweep(engine="async", async_cfg=acfg, n_seeds=2)
    flushes = int(ares.metric("valid").sum())
    expect_launches(ln, delta_pipeline_apply=flushes, delta_pipeline_partial=0)
    h = ev_mod.AsyncFedFogSimulator(dc.replace(cfg, seed=1),
                                    dc.replace(acfg, max_dispatches=SWEEP_ROUNDS),
                                    device="cuda").run()
    nf = h["num_flushes"]
    same = all(np.array_equal(ares.metric(k)[0, 1, :nf], np.asarray(h[k]))
               for k in ("accuracy", "t_ms", "num_aggregated", "energy_j", "mean_staleness"))
    check(same and int(ares.metric("valid")[0, 1].sum()) == nf,
          "async sweep seed 1 differs from the standalone engine's run")
    say("sweep", engine="async", async_cfg="fedbuff(8)", seeds=2, dispatches=SWEEP_ROUNDS,
        flushes=flushes, k3_launches=ln["delta_pipeline_apply"], wall_s=sec,
        wall_s_per_seed=sec / 2, seed1_equals_standalone=same, card=repr(smi))
    return totals


# ---- the LM round: llama3.2-1b at full width through K3, K4 and K2 ---- #
# launch/train.py's defaults: 32 clients, 4 slots, 2 local steps of 4
# sequences of 128 tokens per slot.
TRAIN_ARGV = ["--arch", "llama3.2-1b", "--scale", "full", "--pallas-agg", "--rounds", "3"]
TRAIN_TOKENS = 4 * 4 * 2 * 128  # tokens trained per round
TRAIN_WINDOW = 1 << 26  # columns per window of the plain comparisons


class KernelTap:
    """Wraps ``ops.delta_pipeline_apply`` / ``ops.delta_pipeline_partial``
    (the round looks both up at call time) and, while ``armed``, keeps the
    last call's inputs and, for K3, its outputs, which nothing writes
    after the call; of K4's partial (summed into in place) it keeps every
    4,096th column. Launches nothing of its own."""

    def __init__(self, torch):
        from repro_torch.kernels.delta_pipeline import ops

        self.torch, self.ops, self.armed = torch, ops, False
        self.k3, self.k4 = None, []
        self._apply, self._partial = ops.delta_pipeline_apply, ops.delta_pipeline_partial

    def __enter__(self):
        def apply(updates, *args, **kw):
            outs = self._apply(updates, *args, **kw)
            if self.armed:
                self.k3 = dict(args=(updates,) + args, kw=kw, outs=outs)
            return outs

        def partial(updates, dm, **kw):
            out = self._partial(updates, dm, **kw)
            if self.armed:
                self.k4.append(dict(updates=updates, dm=dm, kw=kw, sample=out[::4096].clone()))
            return out

        self.ops.delta_pipeline_apply, self.ops.delta_pipeline_partial = apply, partial
        return self

    def __exit__(self, *exc):
        self.ops.delta_pipeline_apply = self._apply
        self.ops.delta_pipeline_partial = self._partial


def train_rounds(torch, run, tap, rounds):
    """Run ``rounds`` rounds of ``launch/train.py``'s loop on ``run`` (a
    ``train.Run``), its round arming ``tap`` in the last one, the round's
    host synchronisations counted and its wall time taken between two
    device synchronisations. Returns (per-round records, launches)."""
    from repro_torch.launch import train
    from repro_torch.obs import MemoryTracker

    fn, records = run.round_fn, []

    def instrumented(state, batch):
        tap.armed = len(records) == rounds - 1
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        syncs = count_syncs(torch, lambda: out.append(fn(state, batch)))
        torch.cuda.synchronize()
        records.append(dict(ms=(time.perf_counter() - t0) * 1e3, syncs=syncs))
        tap.armed = False
        return out[0]

    run.round_fn = instrumented
    run.args.rounds = run.start_round + rounds
    tracker = MemoryTracker()
    zero_counts()
    train._train_loop(run, tracker)
    torch.cuda.synchronize()
    launches = read_counts()
    run.round_fn = fn
    for rec, row in zip(records, [r for r in tracker.rows if r.get("event") == "round"]):
        rec.update(loss=row["loss"], wall_ms=row["round_wall_s"] * 1e3)
    return records, launches


def windows(torch, p):
    """Column windows covering [0, p)."""
    return [(lo, min(lo + TRAIN_WINDOW, p)) for lo in range(0, p, TRAIN_WINDOW)]


def hold_k3_momentum(torch, dp, rec) -> dict:
    """K3's (new_flat, new_mu) of the round against the plain version on the
    same inputs, window by window, to the momentum gates' tolerance (ATOL +
    RTOL·|r − i|, i the input each output updates)."""
    upd, base, mask, weights = rec["args"][:4]
    kw = rec["kw"]
    out, mu2 = rec["outs"]
    c, p = upd.shape
    check(kw["momentum"] is not None and kw["server_optimizer"] == "fedavgm",
          "train: K3 not on its momentum route")
    err = step = 0.0
    for lo, hi in windows(torch, p):
        r_out, r_mu = dp.delta_pipeline_ref(
            upd[:, lo:hi], base[lo:hi], mask, weights, lr=kw["lr"],
            momentum=kw["momentum"][lo:hi], server_optimizer=kw["server_optimizer"],
            server_momentum=kw["server_momentum"], aggregator=kw["aggregator"],
            trim_fraction=kw["trim_fraction"])
        for o, r, i in ((out[lo:hi], r_out, base[lo:hi]), (mu2[lo:hi], r_mu,
                                                            kw["momentum"][lo:hi])):
            check(bool(torch.isfinite(o).all()), "train: K3 output not finite")
            bad = (o - r).abs() > ATOL + RTOL * (r - i).abs()
            check(not bool(bad.any()), f"train: K3 differs from plain in [{lo}, {hi})")
            err = max(err, float((o - r).abs().max()))
            step = max(step, float((r - i).abs().max()))
    return dict(C=c, P=p, elements=c * p, past_2_32=c * p > 2**32,
                row3_columns_past_2_32=max(0, p - (2**32 - (c - 1) * p)),
                windows=len(windows(torch, p)), max_abs_err=err, max_abs_step=step,
                atol=ATOL, rtol=f"{RTOL} of |step|")


def hold_k4(torch, dp, cu, recs) -> dict:
    """Each fog's K4 partial of the round: the kernel run again on the
    round's own block equals the round's partial at its sampled columns,
    and equals the plain version, window by window, bit for bit (the
    streaming kernel's every-gate-off route); then the same on the block
    with nonzero weights 1..C_local (a window of fresh clients rarely
    passes the drift gate, so the round's own weights may all be 0)."""
    for f, rec in enumerate(recs):
        upd = rec["updates"]
        ones = torch.arange(1, upd.shape[0] + 1, dtype=torch.float32, device=upd.device)
        for dm in (rec["dm"], ones):
            again = cu.delta_pipeline_partial_cuda(upd, dm, **rec["kw"])
            if dm is rec["dm"]:
                check(torch.equal(again[::4096], rec["sample"]),
                      f"train: K4 fog {f} is not deterministic")
            for lo, hi in windows(torch, upd.shape[1]):
                plain = dp.delta_pipeline_partial_ref(upd[:, lo:hi], dm, **rec["kw"])
                check(torch.equal(again[lo:hi], plain),
                      f"train: K4 fog {f} differs from plain in [{lo}, {hi})")
            del again
    return dict(fogs=len(recs), C_local=recs[0]["updates"].shape[0],
                P=recs[0]["updates"].shape[1],
                round_weights=[rec["dm"].tolist() for rec in recs], equal=True)


def lm_kernel_times(torch, dp, cu, upd, base, mask, weights, mu) -> dict:
    """K3 (momentum route), K4 (one fog's half) and K2 at the LM's shape,
    on the round's own buffer, beside their byte bounds."""
    c, p = upd.shape
    wn, cnt, pre, seg, tab = cu.pipeline_rows(
        upd, mask, weights, None, 0.0, 0.1, clip_norm=0.0, compression="none",
        topk_fraction=0.05, seg_sizes=None, aggregator="fedavg")
    out, mu2 = torch.empty_like(base), torch.empty_like(mu)

    def k3(i):
        cu.launch_pipeline(upd, base, wn, cnt, pre, seg, tab, None, mu, out, mu2,
                           lr=1.0, server_momentum=0.9, compression="none",
                           aggregator="fedavg", server_optimizer="fedavgm")

    half = upd[: c // 2]
    dm = (mask.float() * weights)[: c // 2].contiguous()
    out4 = torch.empty((p,), dtype=torch.float32, device=upd.device)
    t = {
        "k3": cuda_ms(k3, 10, 2),
        "k4": cuda_ms(lambda i: cu.launch_partial(half, dm, None, None, None, out4,
                                                  compression="none"), 10, 2),
        "k2": cuda_ms(lambda i: cu.delta_sq_norms_cuda(upd), 10, 2),
    }
    # one PyTorch call of each function on the same buffer: the weighted
    # sum into the base, one fog's weighted sum, the rows' squared norms
    w = (mask.float() * weights) / torch.sum(mask.float() * weights)
    lib = {
        "k3": cuda_ms(lambda i: torch.addmv(base, upd.t(), w, out=out), 10, 2),
        "k4": cuda_ms(lambda i: torch.mv(half.t(), dm, out=out4), 10, 2),
        "k2": cuda_ms(lambda i: torch.linalg.vecdot(upd, upd, dim=1), 10, 2),
    }
    b3 = 4 * (c * p + 4 * p + c)  # deltas, base, mu in, out, mu out, weights
    b4 = 4 * (c // 2 * p + p + c // 2)
    b2 = 4 * (c * p + c)
    ops = {"k3": 2 * (c * p + 2 * p), "k4": 2 * (c // 2) * p, "k2": 2 * c * p}
    res = {}
    for k, b in (("k3", b3), ("k4", b4), ("k2", b2)):
        bound = max(b / HBM_BYTES_PER_S, ops[k] / FP32_FLOP_PER_S) * 1e3
        res[k] = dict(ms=t[k], library_ms=lib[k], bytes=b, bound_ms=bound,
                      share_of_bound=bound / t[k],
                      bound_by="bytes" if b / HBM_BYTES_PER_S >= ops[k] / FP32_FLOP_PER_S
                      else "operations")
    return res


def phase_train(torch, smi) -> dict:
    """The port's LM round (``launch/train.py``, ``fl.round``) on
    full-width llama3.2-1b: (a) the kernel path, 3 rounds (K3 on its
    momentum route, its outputs held against the plain version on the
    round's own (4, P) buffer past 2^32 elements, no host synchronisation
    in a round, finite losses); (b) the fog tier over a population of
    10^6, 3 rounds (K4 twice a round, each partial held against the plain
    version); (c) one round with clip, int8 and DP noise (K2 and K3 once,
    K2's norms held); (d) a checkpoint saved and restored at --scale tiny
    whose next round equals the uninterrupted one bit for bit. Returns
    the launches of (a)-(c) and the kernels' times at the LM's shape."""
    import dataclasses as dc
    import gc
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.fl import make_round_fn
    from repro_torch.kernels import delta_pipeline as dp
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu
    from repro_torch.launch import train
    from repro_torch.obs import NoopTracker

    totals = {name: 0 for name in kernel_counters()}
    totals["robust_kernel"] = 0

    def add(ln):
        for k, v in ln.items():
            totals[k] += v

    def report(name, recs, ln, peak, **extra):
        # rounds after the first (which sets up cuBLAS and the allocator)
        steady = [r["ms"] for r in recs[1:]] or [recs[0]["ms"]]
        ms = sum(steady) / len(steady)
        say("train", run=name, rounds=len(recs), round_ms=[round(r["ms"], 3) for r in recs],
            loop_wall_ms=[round(r["wall_ms"], 3) for r in recs],
            steady_ms_per_round=ms, tokens_per_wall_s=TRAIN_TOKENS / (ms / 1e3),
            model_flop_share=fpt * TRAIN_TOKENS / (ms / 1e3 * BF16_FLOP_PER_S),
            losses=[round(r["loss"], 5) for r in recs], syncs=[r["syncs"] for r in recs],
            launches=ln, peak_bytes=peak, card=repr(smi), **extra)
        check(all(math.isfinite(r["loss"]) for r in recs), f"train {name}: loss not finite")
        check(all(r["syncs"] == 0 for r in recs),
              f"train {name}: round_fn synchronised with the host {[r['syncs'] for r in recs]}")

    gc.collect()
    torch.cuda.empty_cache()
    count_syncs(torch, lambda: torch.zeros(1, device="cuda").cpu())  # throwaway window

    # (a) the kernel path: K3 once a round on its momentum route
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.Run(train.parse_args(TRAIN_ARGV))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, fpt = run.model.param_count(), run.model.flops_per_token()
    with KernelTap(torch) as tap:
        recs, ln = train_rounds(torch, run, tap, 3)
    add(ln)
    expect_launches(ln, delta_pipeline_apply=3, robust_kernel=0, delta_pipeline_partial=0,
                    delta_sq_norms=0, fedavg_apply=0, flash_attention_fwd=0, wkv6_fwd=0,
                    paged_attention_fwd=0)
    peak_a = torch.cuda.max_memory_allocated()
    report("a: kernel path", recs, ln, peak_a, params=n_params, init_s=init_s)
    held = hold_k3_momentum(torch, dp, tap.k3)
    say("train", kernel="delta_pipeline_apply", check="K3 (momentum route) of round 3 "
        "== plain, window by window", **held)
    upd, base, mask, weights = tap.k3["args"][:4]
    times = lm_kernel_times(torch, dp, cu, upd, base, mask, weights, tap.k3["kw"]["momentum"])
    for k, name in (("k3", "delta_pipeline_apply"), ("k4", "delta_pipeline_partial"),
                    ("k2", "delta_sq_norms")):
        say("train", kernel=name, shape=f"C={upd.shape[0] // (2 if k == 'k4' else 1)}, "
            f"P={upd.shape[1]}", card=repr(smi), **times[k])
    del tap, upd, base, mask, weights, held

    # (c) K2 and K3's clip gate: one round with clip, int8 and DP noise
    fl_c = dc.replace(run.fl_cfg, clip_norm=1.0, compression="int8", dp_sigma=0.01)
    run.round_fn = make_round_fn(run.model, fl_c, flops_per_client_round=fpt
                                 * TRAIN_TOKENS / run.fl_cfg.slots, draws=run.draws)
    run.start_round = run.state.step
    torch.cuda.reset_peak_memory_stats()
    with KernelTap(torch) as tap:
        recs_c, ln = train_rounds(torch, run, tap, 1)
    add(ln)
    expect_launches(ln, delta_pipeline_apply=1, delta_sq_norms=1, delta_pipeline_partial=0,
                    robust_kernel=0)
    report("c: clip + int8 + DP", recs_c, ln, torch.cuda.max_memory_allocated())
    upd = tap.k3["args"][0]
    k2 = cu.delta_sq_norms_cuda(upd)
    plain = dp.delta_sq_norms_ref(upd)
    exact = sum(torch.sum(torch.square(upd[:, lo:hi].double()), dim=1)
                for lo, hi in windows(torch, upd.shape[1]))
    e2 = float((k2 - plain).abs().max())
    tol2 = 1e-5 * float(plain.abs().max())
    check(e2 <= tol2, f"train: K2 norms {e2} > {tol2}")
    say("train", kernel="delta_sq_norms", check="K2 norms of round 4's buffer == plain",
        norms=[round(x, 6) for x in k2.sqrt().tolist()], max_abs_err=e2, tol=tol2,
        kernel_rel_err_vs_float64=float(((k2.double() - exact) / exact).abs().max()),
        plain_rel_err_vs_float64=float(((plain.double() - exact) / exact).abs().max()))
    del plain, exact
    check(tap.k3["kw"]["clip_norm"] == 1.0 and tap.k3["kw"]["compression"] == "int8",
          "train: K3 not on its clip + int8 route")
    del tap, upd, k2, run
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the fog tier over a population of 10^6: K4 once per fog a round
    torch.cuda.reset_peak_memory_stats()
    run = train.Run(train.parse_args(TRAIN_ARGV + ["--fog-nodes", "2",
                                                   "--population", "1000000"]))
    with KernelTap(torch) as tap:
        recs_b, ln = train_rounds(torch, run, tap, 3)
    add(ln)
    expect_launches(ln, delta_pipeline_partial=6, delta_pipeline_apply=0, delta_sq_norms=0)
    report("b: fog 2 + population 10^6", recs_b, ln, torch.cuda.max_memory_allocated())
    say("train", kernel="delta_pipeline_partial", check="K4 per fog of round 3 == plain",
        **hold_k4(torch, dp, cu, tap.k4))
    del tap, run
    gc.collect()
    torch.cuda.empty_cache()

    # (d) checkpoint and resume at --scale tiny on the card
    d = ROOT / "build" / "train_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    run = train.Run(train.parse_args(["--scale", "tiny", "--pallas-agg", "--rounds", "1",
                                      "--ckpt-dir", str(d), "--ckpt-every", "1"]))
    train._train_loop(run, NoopTracker())
    restored = ckpt.restore(str(d), ckpt.latest_step(str(d)), run.state)
    _, batch = run.batch(1)
    a, ma = run.round_fn(run.state, batch)
    b, mb = run.round_fn(restored, batch)
    same = (all(torch.equal(x, y) for x, y in zip(tree.leaves([a.params, a.server_mu]),
                                                   tree.leaves([b.params, b.server_mu])))
            and all(torch.equal(ma[k], mb[k]) for k in ma) and a.step == b.step == 2
            and (a.rng == b.rng).all())
    check(same, "train: the restored state's next round differs from the original's")
    say("train", run="d: checkpoint + resume (tiny)", restored_step=restored.step,
        next_round_bitwise_equal=same)
    shutil.rmtree(d, ignore_errors=True)
    return {"launches": totals, "times": times}


# ---- the client-sharded LM round: dist.selftest on two ranks ------------ #
# Two ranks of one slot each (plan_for(device_count=2, zero=1)) share the
# one card through gloo (its all-reduce stages CUDA tensors through host
# memory; NCCL refuses two ranks on one card). Run as a child process of
# this one: the ranks start with ``spawn``, this process has CUDA set up.
DIST_ARGV = ["-m", "repro_torch.dist.selftest", "--arch", "llama3.2-1b", "--scale", "full",
             "--devices", "2", "--zero", "1", "--pallas-agg", "--gates", "legacy,full",
             "--seq-len", "128", "--local-steps", "2",
             "--device", "cuda", "--backend", "gloo", "--check", "--json"]
DIST_RUNS = (("a: flat, client 2", []), ("b: fog 2 (pod 2 x client 1)", ["--fog-nodes", "2"]))
DIST_TIMEOUT_S = 420


def run_dist(extra, state_dir, argv=DIST_ARGV) -> dict:
    """One ``dist.selftest`` child; its JSON result (it exits non-zero, and
    this raises, if a rank fails or a check does not hold). Its ranks
    share the card with each other and with this process, and their
    allocators map expandable segments: a rank of the LM round peaks near
    34 GB, and with fixed segments one of its 4.61 GiB allocations has
    failed with 4.39 GiB free on the card and 2.98 GiB of the rank's own
    cache reserved but unused."""
    import os

    import torch

    free, total = torch.cuda.mem_get_info()
    say("memory", child=" ".join(extra) or "-", this_process_allocated=torch.cuda.
        memory_allocated(), this_process_reserved=torch.cuda.memory_reserved(),
        card_free=free, card_total=total)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    proc = subprocess.run([sys.executable, *argv, *extra, "--state-dir", str(state_dir)],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=DIST_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    if proc.returncode != 0 or res is None:
        tail = proc.stderr[-3000:] if res is None else json.dumps(res)[-3000:]
        raise RuntimeError(f"dist selftest {extra} exited {proc.returncode}: {tail}")
    return res


def k4_per_rank(torch, cu, dp, p) -> dict:
    """K4 at a rank's LM shape (1, P), on the card alone: held bit for bit
    against its plain version (every gate off), timed beside the plain
    version, the byte bound (P floats read, P written) and two library
    calls of the same function: ``torch.mv`` on the (P, 1) column, and
    ``torch.mul`` of the row by dm, which at C = 1 is the whole sum."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    upd = torch.randn((1, p), generator=gen, device="cuda")
    dm = torch.full((1,), 123.0, device="cuda")
    out = torch.empty((p,), dtype=torch.float32, device="cuda")
    cu.launch_partial(upd, dm, None, None, None, out, compression="none")
    plain = dp.delta_pipeline_partial_ref(upd, dm)
    check(torch.equal(out, plain), "dist: K4 at (1, P) differs from its plain version")
    del plain
    col = upd.t()
    res = dict(
        shape=f"(1, {p})",
        ms=cuda_ms(lambda i: cu.launch_partial(upd, dm, None, None, None, out,
                                               compression="none"), 10, 2),
        plain_ms=cuda_ms(lambda i: dp.delta_pipeline_partial_ref(upd, dm), 3, 1),
        library_ms=cuda_ms(lambda i: torch.mv(col, dm, out=out), 10, 2),
        library_mul_ms=cuda_ms(lambda i: torch.mul(upd[0], dm, out=out), 10, 2),
        bytes=8 * p, bound_by="bytes",
        bound_ms=max(8 * p / HBM_BYTES_PER_S, 2 * p / FP32_FLOP_PER_S) * 1e3,
        equal_to_plain=True,
    )
    del upd, out, col
    return res


def phase_dist(torch, smi) -> dict:
    """The client-sharded LM round (``dist.selftest``): llama3.2-1b at full
    width and depth in bf16 on 2 ranks of one slot each, ``--pallas-agg``,
    a round of gates legacy then one of full (clip, int8, DP, FedAvgM);
    (a) flat, (b) the pod axis as a two-node fog tier. Gates: every check
    of the selftest (the contract on every rank each round, the replicated
    state, rank 0's parameters within one bf16 ulp and momentum within
    2^-20 of its leaf's max of the single-process round with C = 2, run
    by the child after its ranks exit, from rank 0's state before each
    round); K4 once per rank per round, K2 once per rank in the full
    round, K3 never; exactly one delta all-reduce of (P+2)·4 bytes a
    round; finite losses; slots participating. Prints per-rank peak
    bytes, round and all-reduce wall ms; then times K4 at (1, P)."""
    import shutil

    from repro_torch.kernels import delta_pipeline as dp
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    gc.collect()
    torch.cuda.empty_cache()
    state_dir = ROOT / "build" / "dist_states"
    totals = {"delta_pipeline_partial": 0, "delta_sq_norms": 0, "delta_pipeline_apply": 0}
    for name, extra in DIST_RUNS:
        shutil.rmtree(state_dir, ignore_errors=True)
        t0 = time.perf_counter()
        try:
            res = run_dist(extra, state_dir)
        finally:
            shutil.rmtree(state_dir, ignore_errors=True)
        wall = time.perf_counter() - t0
        gates = res["gates"]
        check(res["ok"], f"dist {name}: selftest not ok")
        check(all(math.isfinite(x) for x in res["losses"]), f"dist {name}: loss not finite")
        check(all(n > 0 for n in res["participation"]), f"dist {name}: no slot took part")
        for rank, rounds in enumerate(res["launches"]):
            for g, ln in zip(gates, rounds):
                want = dict(delta_pipeline_partial=1, delta_pipeline_apply=0,
                            delta_sq_norms=1 if g == "full" else 0)
                check(ln == want, f"dist {name}: rank {rank} launched {ln}, want {want}")
                for k, v in ln.items():
                    totals[k] += v
        ars = res["delta_all_reduces"]
        p = res["param_count"]
        for rank, rounds in enumerate(ars):
            for r, ops in enumerate(rounds):
                check(len(ops) == 1 and ops[0]["bytes"] == 4 * (p + 2),
                      f"dist {name}: rank {rank} round {r}: delta all-reduces {ops}")
        check(all(n == [1] * len(gates) for n in res["inter_client_all_reduces"]),
              f"dist {name}: inter-client all-reduces {res['inter_client_all_reduces']}")
        say("dist", run=repr(name), plan=res["plan"]["shape"], gates=gates,
            losses=[round(x, 5) for x in res["losses"]], participation=res["participation"],
            launches_rank0=res["launches"][0], peak_bytes=res["peak_bytes"],
            round_ms=[[round(x, 1) for x in r] for r in res["round_ms"]],
            all_reduce_ms=[[round(ops[0]["ms"], 1) for ops in r] for r in ars],
            all_reduce_bytes=4 * (p + 2), collectives=res["collectives"],
            world_s=round(res["world_s"], 1), reference_s=round(res["reference_s"], 1),
            child_s=round(wall, 1), card=repr(smi))
        for held in res["check"]:
            say("dist", run=repr(name), round=held["round"], gates=held["gates"],
                params=held["params"], server_mu=held.get("server_mu"),
                metric_diffs=held["metric_diffs"])
    gc.collect()
    torch.cuda.empty_cache()
    k4 = k4_per_rank(torch, cu, dp, p)
    say("dist", kernel="delta_pipeline_partial", card=repr(smi), **k4)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": totals, "k4": k4}


# ---- the tensor axes: dist.selftest --model-split on two ranks ------------ #
# Two ranks share the card through gloo, as in phase "dist". (a) runs the
# whole round with the parameters split over tp; (b) one local step of a
# 48-layer config with head_dim split over sp, its depth cut: every rank
# draws the whole tree before it keeps its blocks, and the single-process
# reference holds the whole tree and its gradient.
TP_ARGV = ["-m", "repro_torch.dist.selftest", "--devices", "2", "--zero", "1",
           "--seq-len", "128", "--device", "cuda", "--backend", "gloo", "--check", "--json"]
TP_QWEN_LAYERS = 4
TP_RUNS = (
    ("a: llama3.2-1b, tp 2", ["--arch", "llama3.2-1b", "--scale", "full", "--model-split",
                              "2,1", "--pallas-agg", "--gates", "legacy,legacy,full",
                              "--local-steps", "2"]),
    ("b: qwen2.5-14b, sp 2, one step", ["--arch", "qwen2.5-14b", "--scale", "full",
                                        "--model-split", "1,2", "--mode", "step",
                                        "--layers", str(TP_QWEN_LAYERS)]),
)


def k3_per_rank(torch, dp, cu, p) -> dict:
    """K3 on its momentum route at a tensor-parallel rank's (1, P) (one
    slot; the client axes span one rank), on the card alone: held
    against its plain version window by window, timed beside it, the
    byte bound (the row, base and momentum read, the model and momentum
    written) and ``torch.addmv`` of the same weighted sum into the base."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    upd = torch.randn((1, p), generator=gen, device="cuda").mul_(1e-3)
    base = torch.randn((p,), generator=gen, device="cuda")
    mu = torch.randn((p,), generator=gen, device="cuda").mul_(1e-3)
    mask = torch.ones((1,), dtype=torch.bool, device="cuda")
    weights = torch.full((1,), 123.0, device="cuda")
    kw = dict(lr=1.0, momentum=mu, server_optimizer="fedavgm", server_momentum=0.9,
              aggregator="fedavg", trim_fraction=0.1)
    outs = dp.delta_pipeline_apply(upd, base, mask, weights, lr=1.0, momentum=mu,
                                   server_optimizer="fedavgm", server_momentum=0.9)
    held = hold_k3_momentum(torch, dp, dict(args=(upd, base, mask, weights), kw=kw, outs=outs))
    del outs
    wn, cnt, pre, seg, tab = cu.pipeline_rows(
        upd, mask, weights, None, 0.0, 0.1, clip_norm=0.0, compression="none",
        topk_fraction=0.05, seg_sizes=None, aggregator="fedavg")
    out, mu2 = torch.empty_like(base), torch.empty_like(mu)

    def k3(i):
        cu.launch_pipeline(upd, base, wn, cnt, pre, seg, tab, None, mu, out, mu2, lr=1.0,
                           server_momentum=0.9, compression="none", aggregator="fedavg",
                           server_optimizer="fedavgm")

    col, w = upd.t(), weights / weights
    nbytes = 4 * (p + 4 * p + 1)
    ops = 2 * (p + 2 * p)
    res = dict(
        shape=f"(1, {p})", ms=cuda_ms(k3, 10, 2),
        plain_ms=cuda_ms(lambda i: dp.delta_pipeline_ref(
            upd, base, mask, weights, lr=1.0, momentum=mu, server_optimizer="fedavgm",
            server_momentum=0.9), 1, 1),
        library_ms=cuda_ms(lambda i: torch.addmv(base, col, w, out=out), 10, 2),
        bytes=nbytes, bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_FLOP_PER_S
        else "operations",
        bound_ms=max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3,
        max_abs_err=held["max_abs_err"],
    )
    del upd, base, mu, out, mu2, col
    return res


def phase_tp(torch, smi) -> dict:
    """The tensor axes (``dist.selftest --model-split``, see the module
    docstring's phase 4 "tp"): (a) the llama round over tp 2, (b) one
    qwen2.5-14b step over sp 2; then K3 at a rank's (1, P). Returns the
    K2 / K3 / K4 launches of (a) and K3's times."""
    import shutil

    from repro_torch.kernels import delta_pipeline as dp
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    gc.collect()
    torch.cuda.empty_cache()
    state_dir = ROOT / "build" / "tp_states"
    totals = {"delta_pipeline_partial": 0, "delta_sq_norms": 0, "delta_pipeline_apply": 0}
    p = None
    for name, extra in TP_RUNS:
        shutil.rmtree(state_dir, ignore_errors=True)
        t0 = time.perf_counter()
        try:
            res = run_dist(extra, state_dir, TP_ARGV)
        finally:
            shutil.rmtree(state_dir, ignore_errors=True)
        wall = time.perf_counter() - t0
        check(res["ok"], f"tp {name}: selftest not ok")
        check(res["replicated"], f"tp {name}: the ranks' gathered states differ")
        check(all(math.isfinite(x) for x in res["losses"]), f"tp {name}: loss not finite")
        say("tp", run=repr(name), plan=res["plan"]["shape"], layers=res["layers"],
            params=res["param_count"], dtype=res["dtype"])
        if res.get("mode") == "step":
            say("tp", run=repr(name), cut=f"{res['layers']} of 48 layers", loss=res["losses"][0],
                step_ms=[round(x, 1) for x in res["step_ms"]], peak_bytes=res["peak_bytes"],
                tensor_axis_per_step=res["tensor_axis"], check=res["check"],
                world_s=round(res["world_s"], 1), reference_s=round(res["reference_s"], 1),
                child_s=round(wall, 1), card=repr(smi))
            continue
        gates = res["gates"]
        check(all(n > 0 for n in res["participation"]), f"tp {name}: no slot took part")
        for rank, rounds in enumerate(res["launches"]):
            for g, ln in zip(gates, rounds):
                want = dict(delta_pipeline_apply=1, delta_pipeline_partial=0,
                            delta_sq_norms=1 if g == "full" else 0)
                check(ln == want, f"tp {name}: rank {rank} launched {ln}, want {want}")
                for k, v in ln.items():
                    totals[k] += v
        check(all(ops == [] for r in res["delta_all_reduces"] for ops in r),
              f"tp {name}: delta all-reduces with one client rank {res['delta_all_reduces']}")
        check(all(rec["per_local_step"]["count"] > 0 for r in res["tensor_axis"] for rec in r),
              f"tp {name}: no tensor-axis collective in local training")
        p = res["param_count"]
        say("tp", run=repr(name), gates=gates, losses=[round(x, 5) for x in res["losses"]],
            collectives=res["collectives"], world_s=round(res["world_s"], 1),
            reference_s=round(res["reference_s"], 1), child_s=round(wall, 1), card=repr(smi))
        for rank, rounds in enumerate(res["tensor_axis"]):
            say("tp", run=repr(name), rank=rank, peak_bytes=res["peak_bytes"][rank],
                round_ms=[round(x, 1) for x in res["round_ms"][rank]],
                launches=res["launches"][rank],
                delta_all_reduces_per_round=[len(o) for o in res["delta_all_reduces"][rank]],
                per_local_step=[r["per_local_step"] for r in rounds],
                gather=[{k: r["gather"][k] for k in ("count", "bytes", "ms")} for r in rounds])
        for held in res["check"]:
            say("tp", run=repr(name), round=held["round"], gates=held["gates"],
                params=held["params"], server_mu=held.get("server_mu"),
                metric_diffs={k: v for k, v in held["metric_diffs"].items() if v})
    gc.collect()
    torch.cuda.empty_cache()
    k3 = k3_per_rank(torch, dp, cu, p)
    say("tp", kernel="delta_pipeline_apply", card=repr(smi), **k3)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": totals, "k3": k3}


# ---- serving under mesh rules: dist.selftest --mode serve on two ranks ---- #
# Two ranks share the card through gloo, as in phases "dist" and "tp". Each
# child runs its engines on the ranks, then the single-process engines on
# the same weights and requests, and checks rank 0 against them. (c) cuts
# qwen2.5-14b's depth: every rank draws the whole tree before it keeps its
# blocks, and the child's reference holds it twice (bf16 and float32).
SERVE_DIST_ARGV = ["-m", "repro_torch.dist.selftest", "--mode", "serve", "--devices", "2",
                   "--scale", "full", "--prompt-len", str(PROMPT), "--gen", "16", "--flash",
                   "--device", "cuda", "--backend", "gloo", "--check", "--json"]
SERVE_DIST_QWEN_LAYERS = 4
SERVE_DIST_RUNS = (
    ("a: llama3.2-1b, tp 2", ["--arch", "llama3.2-1b", "--model-split", "2,1", "--engine",
                              "static,continuous", "--batch", "8", "--slots", str(SLOTS),
                              "--requests", "16", "--attn", "paged"]),
    ("b: llama3.2-1b, scaled plan of 2", ["--arch", "llama3.2-1b", "--engine", "static",
                                          "--batch", "8,1"]),
    ("c: qwen2.5-14b, sp 2", ["--arch", "qwen2.5-14b", "--model-split", "1,2",
                              "--layers", str(SERVE_DIST_QWEN_LAYERS), "--engine",
                              "static,continuous", "--batch", "8", "--slots", str(SLOTS),
                              "--requests", "8", "--attn", "paged"]),
)
# (name, B, H, Hkv, Sq, Sk, hd, window, bidirectional) and (name, Hkv, g,
# hd, pages per slot, window): the shapes a rank's heads give K5 and K7 in
# the phase
K5_RANK_TIMES = [
    ("llama tp 2 admission", 1, 16, 4, PROMPT, PROMPT, 64, 0, False),
    ("llama tp 2 static prefill", 8, 16, 4, PROMPT, PROMPT, 64, 0, False),
    ("llama sequence span 1 of 2", 1, 32, 8, PROMPT // 2, PROMPT, 64, 0, False),
    ("qwen sp 2 (whole head_dim)", 1, 40, 8, PROMPT, PROMPT, 128, 0, False),
]
K7_RANK_TIMES = [
    ("llama tp 2 decode", 4, 4, 64, 10, -1),
    ("qwen sp 2 decode", 8, 5, 128, 10, -1),
]


def phase_serve_dist(torch, smi) -> dict:
    """Serving under mesh rules (see the module docstring's phase 4
    "serve_dist"): cases (a)-(c) through ``dist.selftest --mode serve``,
    then K5 and K7 at a rank's heads held against their plain versions
    and timed. Returns the K5 / K7 launches
    summed over every rank and run, and the times."""
    totals = {"flash_attention_fwd": 0, "paged_attention_fwd": 0}
    state_dir = ROOT / "build" / "serve_dist"
    for name, extra in SERVE_DIST_RUNS:
        t0 = time.perf_counter()
        res = run_dist(extra, state_dir, SERVE_DIST_ARGV)
        wall = time.perf_counter() - t0
        layers = res["layers"]
        say("serve_dist", run=repr(name), plan=res["plan"]["shape"], layers=layers,
            cut=None if not name.startswith("c") else f"{layers} of 48 layers",
            params=res["param_count"], dtype=res["dtype"], world_s=round(res["world_s"], 1),
            reference_s=round(res["reference_s"], 1), child_s=round(wall, 1), card=repr(smi))
        for run, held in zip(res["runs"], res["check"]):
            paged = run["engine"] == "continuous" and res["attn"] == "paged"
            want = {"flash_attention_fwd": layers * run["prefills"],
                    "paged_attention_fwd": layers * run["decode_steps"] if paged else 0}
            for rank, ln in enumerate(run["launches"]):
                check(ln == want, f"serve_dist {name}: rank {rank} {run['engine']} "
                      f"launched {ln}, want {want}")
                for k, v in ln.items():
                    totals[k] += v
            check(run["same_on_ranks"], f"serve_dist {name}: the ranks' tokens differ")
            check(run["census"]["count_by_kind"] == run["census"]["expected"],
                  f"serve_dist {name}: census {run['census']}")
            check(held["ok"], f"serve_dist {name}: {run['engine']} {run['n']}: {held}")
            say("serve_dist", run=repr(name), engine=run["engine"], n=run["n"],
                layout=run["layout"]["kind"], census=run["census"]["count_by_kind"],
                census_bytes=run["census_bytes"], launches_rank0=run["launches"][0],
                prefills=run["prefills"], decode_steps=run["decode_steps"],
                prefill_or_admission_ms=run["prefill_ms"], decode_step_ms=run["decode_ms"],
                single_prefill_or_admission_ms=held["single_prefill_ms"],
                single_decode_step_ms=held["single_decode_ms"],
                wall_ms=run["wall_ms"], collective_ms=run["collective_ms"],
                peak_bytes=run["peak_bytes"],
                requests_agreeing=f"{held['requests_agreeing']} of {held['requests']}",
                logits_err=held["logits_err"], logits_tol=LOGITS_RTOL * held["logits_scale"],
                rms_ratio=held.get("rms_ratio"), card=repr(smi))
    gc.collect()
    torch.cuda.empty_cache()
    times = time_attention_cases(torch, K5_RANK_TIMES, K7_RANK_TIMES, 500)
    return {"launches": totals, "times": times}


# ---- the MoE serving slice: moonshot-v1-16b-a3b ------------------------ #
# The served FFN (models/moe.moe_ffn_dropless) against the plain all-experts
# oracle (moe_ffn_reference) on one layer's own input from a real prefill:
#   * float32 (the layer's bf16 weights and input widened): the two compute
#     the same per-row products and differ in the order of their sums, held
#     to MOE_F32_RTOL of the reference's max |value|;
#   * bf16 (the served dtype): both round each projection to bf16; the
#     served route is held no further from the float32 result than the
#     plain bf16 reference is.
MOE_F32_RTOL = 1e-5
MOE_FFN_ITERS = 20  # calls timed per FFN route and input
MOE_LAYER = 24  # the layer whose FFN input is held


@contextlib.contextmanager
def ffn_inputs(records):
    """Append (layer parameters, input) of every ``transformer._ffn_block``
    call to ``records`` (the prefill and both decode modes call it through
    the module)."""
    from repro_torch.models import transformer as tf

    block = tf._ffn_block

    def recorded(lp, cfg, x, runtime=tf.Runtime()):
        records.append((lp, x))
        return block(lp, cfg, x, runtime)

    tf._ffn_block = recorded
    try:
        yield
    finally:
        tf._ffn_block = block


MOE_KEYS = ("w_router", "we_gate", "we_up", "we_down")


def moe_ffn_ms(torch, moe, x, w, cfg) -> dict:
    """Device ms per call of the served MoE FFN and of the all-experts
    oracle on the input ``x`` with one layer's weights ``w``."""
    with torch.no_grad():
        return {name: cuda_ms(lambda i: fn(x, *w, cfg), MOE_FFN_ITERS)
                for name, fn in (("dropless", moe.moe_ffn_dropless),
                                 ("reference", moe.moe_ffn_reference))}


def phase_serving_moe(torch) -> dict:
    """moonshot-v1-16b-a3b at full width and depth in bf16 through the
    serving gates of llama's phase (K5 per admission layer, K7 per decode
    layer), then the MoE gates: (a) the served FFN against the plain
    oracle on a prefill's layer input, (b) a decode step's MoE FFN under
    ``set_sync_debug_mode("error")``; the distinct experts a decode step's
    layers hit, launches per decode step and the host synchronisations of
    a whole decode step. Returns the counted run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tools.profile_serve import profile_calls

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), attn_impl="flash")
    r = serve_checked(torch, cfg)
    model, params = r["model"], r["params"]
    dev = torch.device("cuda")
    prompt = torch.from_numpy(r["trace"].prompts[:1]).to(dev)

    # (a) one layer's own input from a real prefill
    recs = []
    with torch.no_grad(), ffn_inputs(recs):
        model.prefill(params, {"tokens": prompt}, cache_len=PROMPT)
    check(len(recs) == cfg.num_layers, f"{len(recs)} FFN calls in a {cfg.num_layers}-layer prefill")
    lp, x = recs[MOE_LAYER]
    w = [lp[k] for k in MOE_KEYS]
    w32 = [t.float() for t in w]
    with torch.no_grad():
        ref32 = moe.moe_ffn_reference(x.float(), *w32, cfg)
        drop32 = moe.moe_ffn_dropless(x.float(), *w32, cfg)
        served = moe.moe_ffn_dropless(x, *w, cfg)
        plain = moe.moe_ffn_reference(x, *w, cfg)
    scale = float(ref32.abs().max())
    e32 = float((drop32 - ref32).abs().max())
    e_served = float((served.float() - ref32).abs().max())
    e_plain = float((plain.float() - ref32).abs().max())
    del w32, ref32, drop32, served, plain
    prefill_ms = moe_ffn_ms(torch, moe, x, w, cfg)
    prefill_hit = int(torch.unique(moe.router_topk(x.reshape(-1, cfg.d_model), w[0],
                                                   cfg.experts_per_token)[1]).numel())
    check(e32 <= MOE_F32_RTOL * scale,
          f"MoE dropless vs reference in float32: {e32} > {MOE_F32_RTOL} x {scale}")
    check(e_served <= e_plain,
          f"MoE dropless in bf16: {e_served} from float32, the plain bf16 {e_plain}")

    # (b) one decode step's MoE FFN, under sync debug mode "error"; the
    # distinct experts of the step's layers
    recs = []
    with ffn_inputs(recs):
        r["decode"](0)
    check(len(recs) == cfg.num_layers, f"{len(recs)} FFN calls in a decode step")
    lp, xd = recs[MOE_LAYER]
    count_syncs(torch, lambda: torch.zeros(1, device="cuda").cpu())  # throwaway window
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            yd = moe.moe_ffn_dropless(xd, *[lp[k] for k in MOE_KEYS], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(yd).all()), "decode-step MoE FFN not finite")
    decode_ms = moe_ffn_ms(torch, moe, xd, [lp[k] for k in MOE_KEYS], cfg)
    hit = [int(torch.unique(moe.router_topk(xl.reshape(-1, cfg.d_model), lpl["w_router"],
                                            cfg.experts_per_token)[1]).numel())
           for lpl, xl in recs]
    del recs, lp, xd, yd
    torch.cuda.synchronize()
    step_syncs = count_syncs(torch, lambda: r["decode"](1))
    prof = profile_calls(lambda i: r["decode"](2 + i), 2, 3)
    rep = r["rep"]
    say("serve_moe", arch=cfg.name, params=model.param_count(),
        active_params=model.active_param_count(), init_s=r["init_s"], peak_bytes=r["peak"],
        wall_ms_per_admission=r["admit_ms"], wall_ms_per_decode_step=r["decode_ms"],
        tokens_per_wall_s=rep.tokens_per_wall_s,
        k5_per_admission=r["launches"]["flash_attention_fwd"] / rep.prefills,
        k7_per_decode_step=r["launches"]["paged_attention_fwd"] / rep.decode_steps,
        launches_per_decode_step=prof["kernel_launches"],
        device_kernel_ms_per_decode_step=prof["device_kernel_ms"],
        device_busy_share=prof["device_busy_share"],
        top_kernels=[(k["name"][:40], round(k["ms"], 4)) for k in prof["top_kernels"]])
    say("serve_moe", gate_a_layer=MOE_LAYER, f32_max_abs_diff=e32, f32_ref_max_abs=scale,
        f32_tol=f"{MOE_F32_RTOL} x max|ref|", bf16_served_from_f32=e_served,
        bf16_plain_from_f32=e_plain, bf16_tol="the plain bf16 oracle's distance",
        gate_b="moe_ffn_dropless of a decode step under set_sync_debug_mode('error'): held",
        host_syncs_per_decode_step=step_syncs,
        ffn_device_ms_on_the_prefill_input=dict(prefill_ms, tokens=PROMPT,
                                                experts_hit=prefill_hit),
        ffn_device_ms_on_the_decode_input=dict(decode_ms, tokens=SLOTS),
        experts_hit_per_layer_of_a_decode_step=dict(
            mean=sum(hit) / len(hit), min=min(hit), max=max(hit), of=cfg.num_experts,
            tokens=SLOTS, top_k=cfg.experts_per_token))
    return r["launches"]


# ---- the wider configs: one admission batch and a decode step each ----- #
ARCH_CHECKS = ("qwen2.5-14b", "yi-9b", "gemma3-12b")
MIXTRAL_LAYERS = 8  # of 32: 32 layers are 93.4 GB in bf16, past one 80 GB card


def float32_decode_attention(q, k, v, positions, window):
    """The dense decode mode's attention (``attention_decode`` over the
    gathered cache) on float32 copies of q and the cache, rounded once to
    the model dtype: K7 keeps the scores and softmax weights in float32,
    where the bf16 dense mode rounds both to bf16, and over 48 layers that
    rounding alone moves the logits by about LOGITS_RTOL (the bf16 dense
    mode against this one: 5.1 % of max |logit| at qwen2.5-14b and at
    gemma3-12b on an H100). The kernel is held against the plain version
    in float32 rounded once, as phase 3 holds K7."""
    from repro_torch.models.layers import attention_decode

    return attention_decode(q.float(), k.float(), v.float(), positions, window).to(q.dtype)


def first_step(torch, cfg, model, params, prompts, embeds=None) -> dict:
    """SLOTS admissions of ``prompts`` (SLOTS, PROMPT) on the device (a VLM
    config's ``embeds`` (SLOTS, n_patches, d) prepended), K5 = layers x
    SLOTS; then the first decode step of the full slot batch in
    the dense mode with its attention in float32
    (``float32_decode_attention``) and paged, K7 = layers in the paged
    one; paged held within LOGITS_RTOL of the dense mode; then decode
    steps timed. Returns the distance, the wall ms per admission and per
    decode step, the K5 and K7 counts read, and ``decode(i)``, which
    advances the batch one paged step (K7) from position PROMPT + i."""
    from repro_torch.models import Runtime
    from repro_torch.serve import paged

    dev = torch.device("cuda")
    plan = paged.PagePlan.build(cfg, PROMPT, MAX_GEN, page_size=PAGE)
    n_tab = plan.pages_per_slot
    pool = paged.init_pool(cfg, plan, SLOTS, SLOTS * n_tab, device=dev)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    out_buf = torch.zeros((SLOTS + 1, MAX_GEN), dtype=torch.int32, device=dev)
    table = torch.arange(1, SLOTS * n_tab + 1, dtype=torch.int32, device=dev).reshape(SLOTS, n_tab)
    admit = paged.make_admit_fn(model, plan)

    def extra(slot):
        return [] if embeds is None else [embeds[slot:slot + 1]]

    admit(params, {k: x.clone() for k, x in pool.items()}, tokens.clone(), out_buf.clone(),
          prompts[:1], *extra(0), table[0, :plan.prompt_pages].long(), 0, 0)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for slot in range(SLOTS):
        admit(params, pool, tokens, out_buf, prompts[slot:slot + 1], *extra(slot),
              table[slot, :plan.prompt_pages].long(), slot, slot)
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t0) / SLOTS * 1e3
    launches = read_counts()
    expect_launches(launches, flash_attention_fwd=cfg.num_layers * SLOTS, paged_attention_fwd=0,
                    fedavg_apply=0, delta_sq_norms=0, delta_pipeline_apply=0,
                    delta_pipeline_partial=0, wkv6_fwd=0)
    positions = torch.full((SLOTS,), plan.prompt_eff, dtype=torch.int64, device=dev)
    active = torch.ones((SLOTS,), dtype=torch.bool, device=dev)
    logits, k7 = {}, {}
    for mode in ("dense", "paged"):
        zero_counts()
        logits[mode], _ = paged._paged_transformer_step(
            params, cfg, plan, {k: x.clone() for k, x in pool.items()}, tokens, table,
            positions, active, Runtime(), mode, dense_attention=float32_decode_attention)
        torch.cuda.synchronize()
        k7[mode] = read_counts()
        expect_launches(k7[mode], flash_attention_fwd=0,
                        paged_attention_fwd=cfg.num_layers if mode == "paged" else 0)
    check(bool(torch.isfinite(logits["paged"]).all()), f"{cfg.name}: non-finite logits")
    # over the true vocab: the padded rows' logits are -1e30 in both
    v = cfg.vocab_size
    diff = float((logits["paged"][..., :v] - logits["dense"][..., :v]).abs().max())
    scale = float(logits["dense"][..., :v].abs().max())
    check(diff <= LOGITS_RTOL * scale,
          f"{cfg.name}: paged vs dense (float32 attention) first-step logits: "
          f"{diff} > {LOGITS_RTOL} x {scale}")
    same = int((logits["paged"][:, -1].argmax(-1) == logits["dense"][:, -1].argmax(-1)).sum())
    step = paged.make_decode_fn(model, plan, attn="paged")
    out_req = torch.full((SLOTS,), SLOTS, dtype=torch.int64, device=dev)
    out_idx = torch.zeros((SLOTS,), dtype=torch.int64, device=dev)
    state = {"pool": pool, "tokens": tokens, "out_buf": out_buf}

    def decode(i):
        state["pool"], state["tokens"], state["out_buf"] = step(
            params, state["pool"], state["tokens"], state["out_buf"], table, positions + i,
            active, out_req, out_idx)

    n_steps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        decode(i)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / n_steps * 1e3
    return dict(diff=diff, scale=scale, same_next_token=same, admit_ms=admit_ms,
                decode_ms=decode_ms, decode=decode,
                k5_launches=launches["flash_attention_fwd"],
                k7_launches=k7["paged"]["paged_attention_fwd"])


def first_step_checked(torch, cfg) -> dict:
    """``cfg`` at full width in bf16 (random weights from a seed) through
    ``first_step``; init s and peak bytes printed beside its readings.
    Frees the model before returning the K5 / K7 launches."""
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT), generator=gen, device=dev)
    fs = first_step(torch, cfg, model, params, prompts)
    peak = torch.cuda.max_memory_allocated()
    say("serve_archs", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        windows=sorted(set(cfg.layer_windows())), experts=cfg.num_experts,
        params=model.param_count(), active_params=model.active_param_count(), init_s=init_s,
        admissions=SLOTS, k5_launches=fs["k5_launches"], k7_per_paged_step=fs["k7_launches"],
        first_step_logits_max_abs_diff_to_dense_f32_attention=fs["diff"],
        dense_f32_attention_logits_max_abs=fs["scale"], tol=f"{LOGITS_RTOL} x max|dense f32|",
        same_next_token_as_dense_f32_attention=f"{fs['same_next_token']} of {SLOTS}",
        wall_ms_per_admission=fs["admit_ms"], wall_ms_per_decode_step=fs["decode_ms"],
        peak_bytes=peak)
    launches = {"flash_attention_fwd": fs["k5_launches"],
                "paged_attention_fwd": fs["k7_launches"]}
    del model, params, fs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serving_archs(torch) -> dict:
    """qwen2.5-14b, yi-9b and gemma3-12b at full width and depth, then
    mixtral-8x7b at full width with MIXTRAL_LAYERS layers, one at a time
    (each freed before the next). Returns the K5 / K7 launches summed."""
    from repro_torch.configs import get_config

    total = {"flash_attention_fwd": 0, "paged_attention_fwd": 0}
    cfgs = [get_config(a) for a in ARCH_CHECKS]
    cfgs.append(dataclasses.replace(get_config("mixtral-8x7b"), num_layers=MIXTRAL_LAYERS))
    for cfg in cfgs:
        t0 = time.perf_counter()
        ln = first_step_checked(torch, dataclasses.replace(cfg, attn_impl="flash"))
        for kern in total:
            total[kern] += ln[kern]
        say("serve_archs", arch=cfg.name, seconds=time.perf_counter() - t0,
            reduced=(f"{MIXTRAL_LAYERS} of 32 layers" if cfg.num_experts else "nothing"))
    return total


# ---- the HYBRID and VLM families: continuous batching, K5 and K7 -------- #
FAMILY_ARCHS = ("hymba-1.5b", "internvl2-2b")
# hymba's slot states after an admission against the SSM branch of each
# layer recomputed in float32 (float32 copies of the branch's weights, on
# the layer's own bf16 input): the bf16 branch rounds its projections and
# the conv output to bf16 (a relative step of 2^-8) before the float32
# scan, which sums 128 decayed steps of them. Held per layer to
# SSM_STATE_RTOL of the float32 state's max |value|.
SSM_STATE_RTOL = 0.02


@contextlib.contextmanager
def recorded_ssm_inputs(records):
    """Record each hybrid layer's (layer params, normed input) as the
    model's SSM branch receives them."""
    from repro_torch.models import transformer as tf

    real = tf._ssm_branch

    def recorded(lp, cfg, x, state=None, conv_state=None):
        records.append((lp, x))
        return real(lp, cfg, x, state, conv_state)

    tf._ssm_branch = recorded
    try:
        yield
    finally:
        tf._ssm_branch = real


def hymba_states_checked(torch, cfg, model, params, prompt) -> dict:
    """One admission into slot 3 of a fresh pool: every layer's slot SSM
    and conv states against the float32 branch on that layer's input; the
    other slots' states stay zero. Then the plain selective scan alone at
    the admission's shape, timed (it runs once per layer per admission)."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    from repro_torch.serve import paged

    dev = torch.device("cuda")
    plan = paged.PagePlan.build(cfg, PROMPT, MAX_GEN, page_size=PAGE)
    n_tab = plan.pages_per_slot
    pool = paged.init_pool(cfg, plan, SLOTS, SLOTS * n_tab, device=dev)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    out_buf = torch.zeros((SLOTS + 1, MAX_GEN), dtype=torch.int32, device=dev)
    pages = torch.arange(1, plan.prompt_pages + 1, device=dev)
    records = []
    with recorded_ssm_inputs(records):
        paged.make_admit_fn(model, plan)(params, pool, tokens, out_buf, prompt, pages, 3, 3)
    check(len(records) == cfg.num_layers, f"{len(records)} SSM branches recorded")
    errs = {"ssm_state": 0.0, "conv_state": 0.0}
    with torch.no_grad():
        for i, (lp, hs) in enumerate(records):
            lp32 = {k: v.float() for k, v in lp.items() if k.startswith("ssm_")}
            _, s32, c32 = tf._ssm_branch(lp32, cfg, hs.float())
            for key, ref in (("ssm_state", s32[0]), ("conv_state", c32[0])):
                got = pool[key][i, 3]
                err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                check(bool(torch.isfinite(got).all()), f"{cfg.name} layer {i}: {key} non-finite")
                check(err <= SSM_STATE_RTOL, f"{cfg.name} layer {i}: {key} {err} of max "
                      f"|float32| > {SSM_STATE_RTOL}")
                errs[key] = max(errs[key], err)
        others = [s for s in range(SLOTS) if s != 3]
        for key in errs:
            check(not bool(pool[key][:, others].any()), f"{cfg.name}: {key} of another slot")
        # the plain scan at the admission's shape: (1, PROMPT, d_inner), state 16
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        di, st = cfg.d_inner, cfg.ssm_state
        x, dt = (torch.randn((1, PROMPT, di), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        b, c = (torch.randn((1, PROMPT, st), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        dt = dt.abs()
        a_log = torch.zeros((di, st), device=dev)
        d = torch.ones((di,), device=dev)
        scan_ms = cuda_ms(lambda i: ssm.selective_scan(x, dt, a_log, b, c, d), 10, 2)
    return dict(max_ssm_state_err=errs["ssm_state"], max_conv_state_err=errs["conv_state"],
                tol=f"{SSM_STATE_RTOL} x max|float32| per layer",
                selective_scan_ms=scan_ms,
                selective_scan_ms_per_admission=scan_ms * cfg.num_layers)


def phase_serving_families(torch) -> dict:
    """hymba-1.5b (HYBRID) and internvl2-2b (VLM) at full width and depth
    through ``serve_checked``: the continuous engine with K5 prefill and K7
    decode, exact launch counts, the paged first step within LOGITS_RTOL
    of the dense mode with float32 attention; hymba's slot states against
    the float32 branch; the device time of a decode step under the
    profiler. One at a time, each freed before the next. Returns the
    engines' launches summed."""
    from repro_torch.configs import get_config
    from repro_torch.models import Family
    from repro_torch.tools.profile_serve import profile_calls

    total = {name: 0 for name in kernel_counters()}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        torch.cuda.empty_cache()
        r = serve_checked(torch, cfg)
        for kern in total:
            total[kern] += r["launches"][kern]
        extra = {}
        if cfg.family is Family.HYBRID:
            prompt = torch.from_numpy(r["trace"].prompts[:1]).cuda()
            extra = hymba_states_checked(torch, cfg, r["model"], r["params"], prompt)
        prof = profile_calls(r["decode"], 10, 5)
        rep = r["rep"]
        say("serve_families", arch=cfg.name, family=cfg.family.value, layers=cfg.num_layers,
            d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, params=r["model"].param_count(), init_s=r["init_s"],
            peak_bytes=r["peak"], prefills=rep.prefills, decode_steps=rep.decode_steps,
            k5_launches=r["launches"]["flash_attention_fwd"],
            k7_launches=r["launches"]["paged_attention_fwd"],
            wall_ms_per_admission=r["admit_ms"], wall_ms_per_decode_step=r["decode_ms"],
            k7_per_decode_step=r["k7_launches"],
            device_kernel_ms_per_decode_step=prof["device_kernel_ms"],
            device_busy_share_of_decode_step=prof["device_busy_share"],
            launches_per_decode_step=prof["kernel_launches"],
            tokens_per_wall_s=rep.tokens_per_wall_s, seconds=time.perf_counter() - t0,
            reduced="nothing", **extra)
        del r, rep, prof
        gc.collect()
        torch.cuda.empty_cache()
    return total


# ---- the ENCDEC family: the static engine, K5 everywhere but decode self #
SEAMLESS = dict(batch=SLOTS, frames=PROMPT, gen=MAX_GEN)
SEAMLESS_ARGV = ["--arch", "seamless-m4t-medium", "--scale", "full", "--engine", "static",
                 "--flash", "--batch", str(SLOTS), "--prompt-len", str(PROMPT),
                 "--gen", str(MAX_GEN)]


@contextlib.contextmanager
def float32_plain_attention():
    """The plain attention (``attention_xla``) on float32 copies of q, k
    and v, rounded once to the model dtype: the reference K5 is held
    against (K5 keeps its softmax weights in float32, where the bf16
    plain path rounds them to bf16 before p·v)."""
    from repro_torch.models import layers

    real = layers.attention_xla

    def f32(q, k, v, *args, **kw):
        return real(q.float(), k.float(), v.float(), *args, **kw).to(q.dtype)

    layers.attention_xla = f32
    try:
        yield
    finally:
        layers.attention_xla = real


def phase_serving_encdec(torch) -> dict:
    """seamless-m4t-medium at full width and depth through
    ``launch/serve.py``'s static engine with ``--flash`` (batch 8, 128
    frames and 128 tokens, 32 generated): K5 = 36 per prefill (12 encoder,
    12 decoder, 12 cross) + 12 per decode step, nothing else; then the
    prefill's and the first decode step's logits against the same bf16
    model with ``attn_impl="xla"`` on float32 attention, within
    LOGITS_RTOL; wall and device time per admission (the batch's prefill)
    and per decode step. Returns the counted run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models import build_model
    from repro_torch.tools.profile_serve import profile_calls

    dev = torch.device("cuda")
    b, gen_len = SEAMLESS["batch"], SEAMLESS["gen"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = launch.main(SEAMLESS_ARGV)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg = dataclasses.replace(get_config("seamless-m4t-medium"), attn_impl="flash")
    L, Le = cfg.num_layers, cfg.num_encoder_layers
    expect_launches(launches, flash_attention_fwd=(Le + 2 * L) + L * (gen_len - 1),
                    paged_attention_fwd=0, fedavg_apply=0, delta_sq_norms=0,
                    delta_pipeline_apply=0, delta_pipeline_partial=0, wkv6_fwd=0)
    check(tuple(out.shape) == (b, gen_len), f"seamless: output {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "seamless: token out of range")

    # the same weights and batch as the launcher's (seed 0), K5 against
    # the float32 plain attention
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = model.init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref_model = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    batch, cache_len = launch.static_batch(cfg, b, PROMPT, gen_len, 0, dev)
    diffs = {}
    with torch.no_grad():
        zero_counts()
        logits, cache = model.prefill(params, batch, cache_len=cache_len)
        check(read_counts()["flash_attention_fwd"] == Le + 2 * L, "seamless: K5 per prefill")
        with float32_plain_attention():
            ref_logits, ref_cache = ref_model.prefill(params, batch, cache_len=cache_len)
        tok = torch.argmax(ref_logits[:, -1], dim=-1)[:, None]
        diffs["prefill"] = (logits, ref_logits)
        zero_counts()
        step_logits, cache = model.decode_step(params, cache, tok)
        check(read_counts()["flash_attention_fwd"] == L, "seamless: K5 per decode step")
        with float32_plain_attention():
            ref_step, ref_cache = ref_model.decode_step(params, ref_cache, tok)
        diffs["first decode step"] = (step_logits, ref_step)
    report = {}
    for what, (got, ref) in diffs.items():
        check(bool(torch.isfinite(got).all()), f"seamless {what}: non-finite logits")
        v = cfg.vocab_size  # the padded rows' logits are -1e30 in both
        diff = float((got[..., :v] - ref[..., :v]).abs().max())
        scale = float(ref[..., :v].abs().max())
        check(diff <= LOGITS_RTOL * scale, f"seamless {what}: flash vs float32 plain "
              f"attention logits {diff} > {LOGITS_RTOL} x {scale}")
        same = int((got[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).sum())
        report[what] = dict(max_abs_diff=diff, ref_max_abs=scale,
                            same_argmax=f"{same} of {b}")

    state = {}

    @torch.no_grad()
    def admit(i):
        lg, state["cache"] = model.prefill(params, batch, cache_len=cache_len)
        state["tok"] = torch.argmax(lg[:, -1], dim=-1)[:, None]

    @torch.no_grad()
    def decode(i):
        state["cache"]["pos"] = PROMPT + i % (gen_len - 1)
        lg, state["cache"] = model.decode_step(params, state["cache"], state["tok"])
        state["tok"] = torch.argmax(lg[:, -1], dim=-1)[:, None]

    admit(0)
    timed = {}
    for name, fn, n in (("admission", admit, 3), ("decode_step", decode, 10)):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        timed[name] = (time.perf_counter() - t0) / n * 1e3
    prof = profile_calls(decode, 10, 5)
    prof_admit = profile_calls(admit, 2, 5)
    say("serve_encdec", arch=cfg.name, layers=f"{Le} encoder + {L} decoder",
        d_model=cfg.d_model, heads=cfg.num_heads, vocab=cfg.vocab_size,
        params=model.param_count(), init_s=init_s, batch=b, frames=PROMPT, tokens=PROMPT,
        generated=gen_len, launcher_run_s=run_s, peak_bytes=peak, launches=launches,
        k5_per_prefill=Le + 2 * L, k5_per_decode_step=L,
        logits_vs_float32_plain_attention=report, tol=f"{LOGITS_RTOL} x max|ref|",
        wall_ms_per_admission=timed["admission"], wall_ms_per_decode_step=timed["decode_step"],
        device_kernel_ms_per_admission=prof_admit["device_kernel_ms"],
        device_kernel_ms_per_decode_step=prof["device_kernel_ms"],
        device_busy_share_of_decode_step=prof["device_busy_share"],
        launches_per_decode_step=prof["kernel_launches"],
        tokens_per_wall_s=b * gen_len / ((timed["admission"]
                                          + (gen_len - 1) * timed["decode_step"]) / 1e3),
        reduced="nothing")
    del model, params, ref_model, cache, ref_cache, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_async_cli(torch) -> dict:
    """The async engine's CLI smoke on the card: ``python -m
    repro_torch.sim.events.engine --horizon-ms 2000`` (FedBuff(4), 16
    clients, churn), flushes > 0."""
    from repro_torch.sim.events.engine import _smoke

    zero_counts()
    h = _smoke(["--horizon-ms", "2000"])
    launches = read_counts()
    check(h["num_flushes"] > 0 and h["num_dispatches"] > 0,
          f"async smoke: {h['num_flushes']} flushes, {h['num_dispatches']} dispatches")
    say("async_cli", horizon_ms=2000, dispatches=h["num_dispatches"],
        flushes=h["num_flushes"], completions=h["num_completions"],
        final_accuracy=h["final_accuracy"], launches=launches)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say("device", name=repr(kind), count=count, torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=repr(smi))
    limit_w = float(smi.rsplit(",", 1)[1].strip().split()[0])
    if limit_w < 700.0:
        say("device", note=f"power limit {limit_w} W is below the 700 W at which "
            "the 3.35 TB/s of the byte bounds is specified")

    # The plain versions are the reference: float32 products in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per kernel source, all started together
    from repro_torch.kernels import _build
    from repro_torch.kernels import delta_pipeline as dp
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu
    from repro_torch.kernels.fedavg.fedavg import library as fedavg_library
    from repro_torch.kernels.flash_attention.flash_attention import LIBRARY as FA_LIB
    from repro_torch.kernels.flash_attention.flash_attention import SOURCE as FA_SRC
    from repro_torch.kernels.flash_attention.flash_attention import library as fa_library
    from repro_torch.kernels.paged_attention.paged_attention import LIBRARY as PA_LIB
    from repro_torch.kernels.paged_attention.paged_attention import SOURCE as PA_SRC
    from repro_torch.kernels.paged_attention.paged_attention import library as pa_library
    from repro_torch.kernels.wkv6.wkv6 import LIBRARY as WKV_LIB
    from repro_torch.kernels.wkv6.wkv6 import SOURCE as WKV_SRC
    from repro_torch.kernels.wkv6.wkv6 import library as wkv_library

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _build.build_libraries({"fedfog_delta_pipeline": [cu.SOURCE], FA_LIB: [FA_SRC],
                            PA_LIB: [PA_SRC], WKV_LIB: [WKV_SRC]})
    say("build", libraries=4, wall_s=time.perf_counter() - t0)
    fedavg_library()  # K1's entry point in the delta pipeline's library
    for kl in (cu.library(), fa_library(), pa_library(), wkv_library()):
        ptxas = [ln.strip() for ln in kl.log_path.read_text().splitlines()
                 if "registers" in ln or "bytes stack" in ln or "Compiling entry" in ln]
        say("build", library=kl.path.name, seconds=kl.build_seconds)
        for ln in ptxas:
            print(f"[build] ptxas {ln}", flush=True)
    # the streaming kernel's instantiations: registers, shared memory, spills
    streaming = fedavg_ptxas(cu.library().log_path.read_text())
    check(len(streaming) == 3, f"fedavg_kernel instantiations in ptxas: {streaming}")
    for entry in streaming:
        say("build", **entry)
        check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
              f"{entry['kernel']} spills")
    # robust_kernel: N2 = 1 .. 64 with the column in registers, 128 and 256
    # in shared memory; none spills, and a column kept in registers leaves
    # no stack
    robust = robust_ptxas(cu.library().log_path.read_text())
    check(len(robust) == 9, f"robust_kernel instantiations in ptxas: {robust}")
    for entry in robust:
        say("build", **entry)
        check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
              f"robust_kernel N2={entry['N2']} spills")
        if entry["column"] == "registers":
            check(entry["stack"] == 0, f"robust_kernel N2={entry['N2']}: column on the stack")
    # K6: the chunk-parallel kernel's plan at the prefill's shape, and its
    # instantiations
    say("build", kernel="wkv6_fwd", B=1, H=RWKV_HEADS,
        **wkv6_plan(wkv_library().lib, 1, RWKV_HEADS))
    k6_entries = wkv6_ptxas(wkv_library().log_path.read_text())
    check(len(k6_entries) == 4, f"wkv6 instantiations in ptxas: {k6_entries}")
    for entry in k6_entries:
        say("build", **entry)

    # K5 and K7 at head_dim 256: registers and spills (printed, not gated:
    # K5's bf16 route at 256 keeps q in shared memory and 32-key tiles)
    for kl, kernel in ((fa_library(), "flash_fwd_bf16_kernelILi256"),
                       (fa_library(), "flash_fwd_f32_kernelILi256"),
                       (pa_library(), "paged_decode_split_kernelI13__nv_bfloat16Li256"),
                       (pa_library(), "paged_decode_split_kernelIfLi256")):
        entries = ptxas_entries(kl.log_path.read_text(), kernel)
        check(len(entries) == 1, f"{kernel}: {len(entries)} instantiations in ptxas")
        entry = entries[0]
        entry.pop("mangled")
        say("build", kernel=kernel.replace("ILi256", "<256>").replace(
            "I13__nv_bfloat16Li256", "<bf16, 256>").replace("IfLi256", "<float, 256>"),
            **entry)

    say("phase", name="build", seconds=time.perf_counter() - t_phase)

    # 3. kernels against their plain versions, then timing
    t_phase = time.perf_counter()
    kernels = {k["name"]: k for k in phase_kernels(torch, dp)}
    kernels.update((k["name"], k) for k in phase_attention_kernels(torch))
    for name, rec in time_attention_256(torch).items():
        kernels[name]["head_dim_256"] = rec
    for name, rec in time_attention_families(torch).items():
        kernels[name]["families"] = rec
    k6 = phase_wkv6_kernel(torch)
    kernels[k6["name"]] = k6
    say("phase", name="kernels", seconds=time.perf_counter() - t_phase)

    # 4. the slices: the port's main paths; K1 is on none of them, and its
    # launches are summed over every counted run
    from repro_torch.fl import simulator as sim_mod

    k1_launches = 0
    t_phase = time.perf_counter()
    run_slice(torch, sim_mod, 1)  # warm-up: cuBLAS handles, allocator
    hist, launches, _, seconds, peak = run_slice(torch, sim_mod, 20)
    expect_launches(launches, delta_pipeline_apply=20, delta_pipeline_partial=0,
                    robust_kernel=0)
    k1_launches += launches["fedavg_apply"]
    kernels["delta_sq_norms"]["launches"] = launches["delta_sq_norms"]
    kernels["delta_pipeline_apply"]["launches"] = launches["delta_pipeline_apply"]
    acc = hist["accuracy"]
    say("slice", rounds=20, k3_launches=launches["delta_pipeline_apply"],
        k2_launches=launches["delta_sq_norms"], ms_per_round=seconds / 20 * 1e3,
        peak_bytes=peak, accuracy=[round(a, 4) for a in acc],
        num_selected=hist["num_selected"][0], cold_starts_round0=hist["cold_starts"][0])
    check(hist["cold_starts"][0] == hist["num_selected"][0],
          "round-0 cold starts != selected clients")
    check(acc[-1] >= 0.85, f"final accuracy {acc[-1]} < 0.85")
    for agg in ("median", "trimmed"):
        h, ln, _, sec, pk = run_slice(torch, sim_mod, 3, aggregator=agg)
        expect_launches(ln, delta_pipeline_apply=3, robust_kernel=3)
        k1_launches += ln["fedavg_apply"]
        say("slice", aggregator=agg, rounds=3, k3_launches=ln["delta_pipeline_apply"],
            robust_kernel_launches=ln["robust_kernel"],
            ms_per_round=sec / 3 * 1e3, accuracy=[round(a, 4) for a in h["accuracy"]])

    run_slice(torch, sim_mod, 1, **POP_FOG)  # warm-up of the population path
    hist, launches, init_s, seconds, peak = run_slice(torch, sim_mod, 20, **POP_FOG)
    expect_launches(launches, delta_pipeline_partial=80, delta_pipeline_apply=0,
                    delta_sq_norms=0)
    k1_launches += launches["fedavg_apply"]
    kernels["delta_pipeline_partial"]["launches"] = launches["delta_pipeline_partial"]
    acc = hist["accuracy"]
    say("slice", path="population+fog", population=POP_FOG["population"],
        cohort=POP_FOG["num_clients"], fog_nodes=POP_FOG["fog_nodes"], rounds=20,
        k4_launches=launches["delta_pipeline_partial"],
        k3_launches=launches["delta_pipeline_apply"],
        k2_launches=launches["delta_sq_norms"], init_s=init_s,
        ms_per_round=seconds / 20 * 1e3, peak_bytes=peak,
        accuracy=[round(a, 4) for a in acc], num_selected=hist["num_selected"])
    check(max(hist["num_selected"]) <= 24, "more than top-k = 24 clients selected")
    check(acc[-1] >= POP_FOG_MIN_ACCURACY,
          f"final accuracy {acc[-1]} < {POP_FOG_MIN_ACCURACY}")
    for name, over, want in (
        ("population, one fog", dict(POP_FOG, fog_nodes=1),
         dict(delta_pipeline_apply=3, delta_pipeline_partial=0)),
        ("dense, four fogs", dict(fog_nodes=4),
         dict(delta_pipeline_partial=12, delta_pipeline_apply=0)),
    ):
        h, ln, ini, sec, _ = run_slice(torch, sim_mod, 3, **over)
        expect_launches(ln, **want)
        k1_launches += ln["fedavg_apply"]
        say("slice", path=repr(name), rounds=3, launches=ln, init_s=ini,
            ms_per_round=sec / 3 * 1e3, accuracy=[round(a, 4) for a in h["accuracy"]])

    say("phase", name="slices", seconds=time.perf_counter() - t_phase)

    # the robustness path: attacks, HAR, faults, the quorum carry-over, the
    # host synchronisations and a tap
    t0 = time.perf_counter()
    rob = phase_robustness(torch, sim_mod, smi)
    say("robustness", phase_s=time.perf_counter() - t0)
    say("phase", name="robustness", seconds=time.perf_counter() - t0)
    k1_launches += rob["fedavg_apply"]
    kernels["delta_pipeline_apply"]["robustness_launches"] = rob["delta_pipeline_apply"]
    kernels["delta_pipeline_apply"]["robust_kernel_launches"] = rob["robust_kernel"]
    kernels["delta_pipeline_partial"]["robustness_launches"] = rob["delta_pipeline_partial"]

    # the asynchronous event engine (K3 on its staleness route, K4 per fog,
    # robust_kernel under median), then run_sweep over both engines
    t0 = time.perf_counter()
    asy = phase_async(torch, sim_mod, smi)
    say("phase", name="async", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    swp = phase_sweep(torch, sim_mod, smi)
    say("phase", name="sweep", seconds=time.perf_counter() - t0)
    for key, counts in (("async", asy), ("sweep", swp)):
        k1_launches += counts["fedavg_apply"]
        kernels["delta_pipeline_apply"][f"{key}_launches"] = counts["delta_pipeline_apply"]
        kernels["delta_pipeline_apply"][f"{key}_robust_kernel_launches"] = \
            counts["robust_kernel"]
        kernels["delta_pipeline_partial"][f"{key}_launches"] = counts["delta_pipeline_partial"]

    # the serving slices: llama (K5 per admission, K7 per decode step), then
    # rwkv6 (K6 per layer of every admission)
    t0 = time.perf_counter()
    launches = phase_serving(torch)
    say("phase", name="serving", seconds=time.perf_counter() - t0)
    k1_launches += launches["fedavg_apply"]
    kernels["flash_attention_fwd"]["launches"] = launches["flash_attention_fwd"]
    kernels["paged_attention_fwd"]["launches"] = launches["paged_attention_fwd"]
    t0 = time.perf_counter()
    launches = phase_serving_rwkv6(torch)
    say("phase", name="serving_rwkv6", seconds=time.perf_counter() - t0)
    k1_launches += launches["fedavg_apply"]
    kernels["wkv6_fwd"]["launches"] = launches["wkv6_fwd"]

    # the MoE family (moonshot-v1-16b-a3b, K5 / K7 at head_dim 128, one kv
    # head per query head), the wider dense configs (gemma3-12b: K5 and K7
    # at head_dim 256) and mixtral-8x7b cut to 8 layers; hymba-1.5b (K5 and
    # K7 at a group of 5, beside the SSM branch) and internvl2-2b (136-row
    # prompts) through the continuous engine; seamless-m4t-medium through
    # the static engine (K5 on its encoder, decoder and cross-attention);
    # then the async engine's CLI smoke
    for name, fn in (("serving_moe", phase_serving_moe), ("serving_archs", phase_serving_archs),
                     ("serving_families", phase_serving_families),
                     ("serving_encdec", phase_serving_encdec),
                     ("async_cli", phase_async_cli)):
        t0 = time.perf_counter()
        launches = fn(torch)
        gc.collect()
        torch.cuda.empty_cache()
        say("phase", name=name, seconds=time.perf_counter() - t0)
        k1_launches += launches.get("fedavg_apply", 0)
        for kern in ("flash_attention_fwd", "paged_attention_fwd"):
            kernels[kern][f"{name}_launches"] = launches[kern]

    # the LM round: llama3.2-1b at full width through K3, K4 and K2
    t0 = time.perf_counter()
    trn = phase_train(torch, smi)
    say("phase", name="train", seconds=time.perf_counter() - t0)
    k1_launches += trn["launches"]["fedavg_apply"]
    kernels["fedavg_apply"]["launches"] = k1_launches
    for key, name in (("k3", "delta_pipeline_apply"), ("k4", "delta_pipeline_partial"),
                      ("k2", "delta_sq_norms")):
        kernels[name]["train_launches"] = trn["launches"][name]
        kernels[name]["train_ms"] = trn["times"][key]["ms"]
        kernels[name]["train_bound_ms"] = trn["times"][key]["bound_ms"]
        kernels[name]["train_library_ms"] = trn["times"][key]["library_ms"]

    # the client-sharded LM round on two ranks sharing the card (gloo): K4
    # once per rank per round, K2 in the clipped round
    t0 = time.perf_counter()
    dst = phase_dist(torch, smi)
    say("phase", name="dist", seconds=time.perf_counter() - t0)
    for name in ("delta_pipeline_partial", "delta_sq_norms", "delta_pipeline_apply"):
        kernels[name]["dist_launches"] = dst["launches"][name]
    k4 = kernels["delta_pipeline_partial"]
    for key in ("ms", "plain_ms", "library_ms", "library_mul_ms", "bound_ms"):
        k4[f"dist_{key}"] = dst["k4"][key]
    k4["dist_shape"] = dst["k4"]["shape"]

    # the tensor axes: two ranks holding their blocks of the parameters, K3
    # once per rank per round on the gathered rows, K2 in the clipped round
    t0 = time.perf_counter()
    tpr = phase_tp(torch, smi)
    say("phase", name="tp", seconds=time.perf_counter() - t0)
    for name in ("delta_pipeline_partial", "delta_sq_norms", "delta_pipeline_apply"):
        kernels[name]["tp_launches"] = tpr["launches"][name]
    k3 = kernels["delta_pipeline_apply"]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err"):
        k3[f"tp_{key}"] = tpr["k3"][key]
    k3["tp_shape"] = tpr["k3"]["shape"]

    # serving under mesh rules: two ranks on their heads (K5 per admission,
    # K7 per decode step), batch- and sequence-parallel static serving
    t0 = time.perf_counter()
    sdr = phase_serve_dist(torch, smi)
    say("phase", name="serve_dist", seconds=time.perf_counter() - t0)
    for name in ("flash_attention_fwd", "paged_attention_fwd"):
        kernels[name]["serve_dist_launches"] = sdr["launches"][name]
        kernels[name]["rank_heads"] = sdr["times"][name]

    # 5. result: K1 to K7
    print(json.dumps({"kernels": [kernels[name] for name in kernel_counters()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
