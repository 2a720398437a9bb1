#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and holds each against its plain PyTorch version on
   the card: K1 tiled accumulate, K2 atomic accumulate, K3 put and its
   flush wait, K4 put+signal, K5 ring all-reduce, K6 accumulate+signal —
   every op and dtype the kernel takes, a ragged tail, ordered and
   unordered, and the paths' own shapes (K1 also on misaligned column
   slices of a wider window; K5 also at 40 random ragged shapes and at the
   gradient shape, against the sum oracle); K7 flash attention at the JAX
   kernel test's four shapes and at (1, 32, 1024, 128) bfloat16 with GQA
   32/8, and the prefill's own call on head-transposed views at 1016
   tokens; K8 at the JAX kernel test's three shapes (float32 and
   bfloat16) and the prefill's (1, 2048, 32 x 64), N 128, chunk 64 in
   bfloat16, and the SSD pass on K8's outputs at the same shapes, with and
   without an initial state; both again at ``jamba-v0.1-52b``'s Mamba2
   shape (1, 1024, 128 x 64), N 16, in float32 and bfloat16, with the card
   scan on its ragged 1016 rows; the whole card scan (K8 + pass) against the
   sequential oracle in float32 (an initial state, ragged lengths) and
   against the plain scan at the 2040-token prefill in bfloat16, one scan
   traced to show it is two kernels; K4's check mode counts the copy
   units a consumer read behind a raised flag that differ from what was
   sent (must be 0), in the launch the paths run.  K7 names the variant
   each call ran (float32: the SIMT kernel; bfloat16: wgmma on TMA-fed
   tiles, whose ``ptxas -v`` registers, spills and shared memory are
   printed after the build).  Times kernel, plain version and the nearest
   single PyTorch call by CUDA-graph replay, so the times are the card's
   alone (K8, its pass and the flush wait have no such call; the wait's plain
   version copies from the host and is timed by calls), and K1-K3's and
   the wait's wrapper calls back to back (``call_ms``, host included);
   K1 a second time past L2 at (4, 2^23) beside ``add_``; K5 by CUDA
   events at the gradient shape beside ``torch.sum(x, 0)``, both on their
   first call after a large free and warmed, with K5's achieved rate and
   design; K1's, K5's, K8's and the pass's ``ptxas -v`` registers and
   spills;
   K7's achieved TFLOP/s and its ratio to ``scaled_dot_product_attention``.
   K3 and K2 also with their address from device memory (per-origin
   displacements, one past the row and one negative; fresh and stale memory
   handles under the lifetime guard), each against its plain version, and
   at the P5 tour's shapes beside ``index_copy_`` / ``index_add_``; an empty kernel (the
   launch floor, plain and programmatic, from ``csrc/probes.cu``); the
   put -> wait pair with and without programmatic launch, 0 stalls; stream
   order across a thread flush that does not own the put before it (the
   put's source overwritten right after the flush, what landed intact).
   K3 on a pinned host window (the tiered KV pool's cold tier): a guarded
   put into pinned host memory and a guarded read out of it at one
   ``qwen3-4b`` page payload, a ragged size at an odd offset, a stale
   handle (put dropped, read zeroed, each counted) and a length past a
   whole number of the grid's strides, bit for bit against its
   plain version; an unpinned CPU buffer beside card tensors raises; one
   page each way by graph replay beside ``copy_`` to and from pinned
   memory, its bound the bytes over the host link's nominal rate (PCIe
   generation and width from ``nvidia-smi``); what bounds it
   (``benchmarks_torch/host_link.py``'s ``[host-link]`` lines): a read's
   round trip, K3's loop over the grid with its bytes in flight, a second
   pinned buffer.  K3 and K2 under the
   guard also with handles whose slot word differs by rank (the addressed
   rank's own slot decides).  K4 at the doorbell's shape
   (8, 1) int32 and K3 at a pushed page's, (8, 1,179,648) bf16 through
   memory handles, each against its plain version, timed beside the launch
   floor and ``index_copy_``.
2. Drives each path with every launch counter at 0 just before it and
   reads the counters just after: the window layer (allocate →
   dup_with_info → ring put with a thread-scope flush → declared
   accumulates below and above the crossover → an undeclared one →
   put_signal on an ordered and an unordered window), each phase-ledger
   count held to the reference cost model; a doorbell after a stalled
   flush (``[stall]``): K3's wait held short (owed = ticks + 1), then
   ``put_signal(..., after=token)`` — the payload lands, K4 withholds every
   bell and counts it, and without the stall every bell rises, as on the
   CPU's plain versions; the P5 tour (``[p5]``): a
   dynamic window over 4 ranks' 2^24-float pools, handle puts, accumulates
   (intrinsic, tiled), gets, a stale handle dropped, zeroed and counted,
   the query and active-message slow paths, a plan's handle ops and an
   allocated window at per-rank tensor displacements — the same tour on the
   CPU's plain versions equal bit for bit, the ledger at the reference's
   38 phases; a handle put one K3 launch like an allocated put; no host
   synchronization under ``set_sync_debug_mode("error")``; a captured
   handle put + flush replayed; paper Fig. 12 (put + thread flush at 8,
   2^10, 2^20 floats: allocated, handle, handle per op, query, AM) by graph
   replay and by calls; a data-parallel ``qwen3-4b``
   train step at full width (depth cut to 2 layers) over 4 stacked ranks
   with the one-sided ring gradient sync (every train step rematerializes
   each scanned period, ``remat="block"``, the default); the planned
   all-to-all at the MoE
   exchange's shape, held bit for bit to the same plan run op by op; and an
   expert-parallel ``llama4-maverick-400b-a17b`` train step at full width
   (2 layers, 8 of 128 experts, 4 stacked expert ranks) whose dispatch and
   combine exchanges run on K4 and K6, forward, in the recompute of the
   rematerialized period and backward — 3(n-1) launches each a step,
   derived from the layer plan; and the
   serving path: ``qwen3-4b`` at all 36 layers and published widths behind
   a dense engine and a paged engine with copy-on-write prefix sharing,
   one request set each, every prefill's attention on K7 — greedy tokens
   equal bit for bit, the page pool conserved, K7 launched 36 times per
   prefill, and one prefill's logits held to the same prefill on K7's
   plain version; the tiered pool (``[serve-tier]``): the same model,
   parameters and requests behind ``kv_pages=(2 x 128, 4 x 128)`` with
   prefix sharing — two sequences in HBM, four in a ``HostKVTier`` in
   pinned host memory — greedy tokens equal dense bit for bit, pages
   demoted and promoted, no stale drop, ``max_live`` at least twice the
   all-HBM paged engine's at 2 x 128 pages, both tiers drained and
   conserved, every page moved by one guarded K3 launch on the host window,
   no host synchronization inside ``HostKVTier.step``, and one sequence's
   demote and promote timed beside ``copy_``; disaggregated prefill ->
   decode (``[serve-disagg]``): the 8 ``qwen3-4b`` prompts prefilled once,
   cut into 64 pages each in the tier's format and pushed by 8 stacked
   ranks on a ring (2 sequences each on 2 lanes) into a 193-page pool a
   rank with ``serve/disagg.py``'s own functions — handle exchange,
   ``push_sequence`` (the doorbell ``after=`` the pool's completion token),
   lane flushes, ``claim_slots``, ``read_doorbell``, ``migrate_pages`` of
   one sequence and a read through a freed page's handle — every page bit
   for bit, bells, tickets, the stale read zeroed and counted, the ledger
   at the reference cost model, no host synchronization from the first
   push to the last claim, 0 stalls, one guarded K3 launch a page moved and
   one K4 a doorbell, and the token's edge across CUDA streams (a push
   held by a spin, its doorbell on another stream waits); the elastic
   runtime (``[serve-elastic]``): the ``[serve]`` requests through
   ``ElasticServing`` on the paged + COW engine with worker 1 dead at tick
   4 — tokens equal dense bit for bit, worker 1 evicted, its slots
   offline, the pool conserved, no claim outstanding; and ``mamba2-370m``
   at all 48 layers and published
   widths behind a dense engine, 8 requests of 2040-token prompts, every
   prefill's SSD scan on K8 and the pass — each launched 48 times per
   prefill, every request's 32 tokens in the vocabulary, one prefill's
   logits held to the same prefill on their plain composition and the next
   decode step finite; ``mamba2-370m`` trained (``[train-ssm]``): all 48
   layers, 4 stacked ranks with the ring gradient sync, batch 8 x 512, 3
   steps — loss finite and falling, K5 once a step, no K8 or pass launch in
   a step (a Mamba2 block that trains calls ``ssd_chunked``, in the
   recompute too), and the trained model's no-grad prefill on K8 and the
   pass 48 times each; then one step at ``remat="none"``, its peak memory
   beside the rematerialized steps'; checkpoint, preemption and resume
   (``[train-ckpt]``): ``mamba2-370m`` cut to 8 layers on the same ring, 6
   steps saving every 2 (2 kept), a run preempted at step 4 and resumed —
   K5 once a step in each run, the resumed losses held to the
   uninterrupted run's, the final checkpoint restored onto the card bit for
   bit, a save's bytes, host copy and write timed, the directory removed;
   the error-feedback compressed all-reduce (``[compress]``) at
   ``mamba2-370m``'s gradient size, (4, 368,494,080) float32, int8 and
   top-k at 1 % — one K5 launch a call, the result bit for bit the
   restored rows summed by K5's plain version, residuals exact, an int8
   payload bit for bit the CPU's, the wire ratios; and
   the hybrid stack (``[serve-hybrid]``): ``jamba-v0.1-52b`` at published
   widths cut to one period (8 of 32 layers: 7 Mamba2, 1 attention, 4 MoE
   of all 16 experts) behind a dense and a paged + COW engine with the
   ``[serve]`` request set — greedy tokens equal bit for bit, the pool
   conserved, a page payload the attention layer's KV alone, per prefill
   K7 once and K8 and the pass 7 times, one prefill's logits held to the
   same prefill on the plain versions and the next decode step finite;
   then the last three families, each after the one before is freed:
   ``[serve-mla]``: ``deepseek-v2-236b`` at published widths cut to 4 of
   60 layers (1 dense, 3 MoE of all 160 experts; 3 layers where the free
   memory cannot hold 4, printed), the ``[serve]`` request set through the
   dense engine — tokens in the vocabulary, the paged engine refused, the
   latent cache's bytes a token a layer, one prefill's last logits held to
   the forward's (each made twice, printed whether equal bit for bit), and
   fault 5 traced — the bf16 ``index_add`` MoE combine twice on the same
   inputs, the fixed-order combine twice and one MoE layer's ``"gspmd"``
   forward twice (the last two must be equal); ``[serve-vlm]``: ``internvl2-1b`` at all 24 layers, dense
   and paged + COW — tokens equal bit for bit, K7 24 times a prefill, one
   prefill with 256 patch embeddings on K7 held to the same on its plain
   version; ``[encdec]``: ``whisper-base`` at 6 + 6 layers, 4 rows of 1500
   frames and a 128-token prompt — K7 18 times in the prefill (6 encoder
   and 6 cross calls non-causal, 6 decoder causal), its logits held to the
   plain version's, 32 greedy decode steps held to the forward, and the
   engine's refusal of the family.  K7's two whisper calls (encoder 1500 x
   1500 with a ragged last key tile, cross 128 x 1500) are held to the plain
   version in float32 and bfloat16 in part 1, the cross call timed beside
   SDPA as its own row.  The plan backends (``[backends]``, inside the
   ``[train]`` phases): the ring macro at the ``qwen3-4b`` gradient's
   shape (4, 980,431,872) float32 and the all-to-all macro at the
   ``[a2a]`` blocks (dispatch and combine) on ``rma``, ``gspmd`` and the
   walker (``interpret``; its ring at (4, 2^24)), bit for bit on
   integer-valued payloads, then timed by CUDA events; the rows written
   in the format ``core/rma/backends/costmodel.py`` reads, to a
   temporary file that ``RMA_TORCH_BACKEND_BENCH_JSON`` points at, and
   ``compile(backend="auto")`` held to pick each measured minimum and
   record why; the ``[train]`` ``qwen3-4b`` run again under
   ``backend="gspmd"`` (0 K5, 0 ring phases, losses within 1e-3 of the
   ring's) and under ``"auto"``; the ``[train]`` ``llama4-maverick`` run
   under ``ep_backend="gspmd"`` (0 K4, K6, K3 and waits) and ``"auto"``,
   losses equal the ``rma`` steps' bit for bit;
   the imperative ``ring_reduce_scatter`` (``order`` x ``bidirectional``)
   then ``ring_all_gather`` on a lent window at the gradient's shape —
   equal to K5's sum bit for bit, ledgers equal to the cost model, K3
   launches and waits counted — and ``rma_all_reduce`` warning once.
   The dry-run against the card (``[dryrun-card]``, after ``[train]``):
   ``launch/dryrun.py::run_cell`` of the ``[train]`` configuration
   (``qwen3-4b`` x2, batch 8 x 512, bf16 parameters and compute) on a
   1 x 1 mesh — its argument bytes equal, exactly, what the caching
   allocator is asked for when the same parameters, AdamW state and
   batch are made on the card (``memory_allocated`` grows by the same
   tensors in 512-byte blocks, plus the segment tails under 1 MiB the
   allocator keeps whole), its meta run's dot FLOPs equal
   ``FlopCounterMode``'s count of one real step on the card, exactly; the
   measured step ms beside the roofline's ``compute_s`` and ``memory_s``,
   the MFU (model FLOPs over step s × 989e12, with the card's name and
   power limit) and the predicted peak beside ``max_memory_allocated`` —
   and on a 4 x 1 mesh under ``rma_ring``: the ring's predicted phases
   equal the phase ledger of each card step, K5 once a step.  The four
   examples (``[examples]``, last): ``examples_torch/{quickstart,
   rma_patterns,serve_decode,train_lm}.py``'s ``main()`` in this process
   with their default arguments, on the card, each with the launch
   counters at 0 just before it — its own asserts hold (``train_lm``'s
   loss falls below ln(vocab) - 1 over its 300 steps), its ``*_OK`` line
   is printed, the kernels it reaches launched (``EXAMPLE_KERNELS``), its
   wall seconds and launches by kernel printed; ``rma_patterns``'s ledger
   counts on the card equal its counts from a ``--device cpu`` run in this
   process.
3. The dry-run sweep (``[dryrun]``): ``python -m repro_torch.launch.dryrun
   --arch all --both-meshes`` runs on the ``meta`` device in a subprocess
   that sees no card, started after the build and run beside the card
   phases; every runnable arch x shape cell ``ok`` on the 16 x 16 mesh and
   the 2 x 16 x 16 one (from the same meta run), ``long_500k`` of a
   full-attention stack ``skipped`` with the reference's reason, one line a
   cell (arguments and peak GiB a device, FLOPs a device, the useful
   ratio, the roofline terms, the dominant one) and the sweep's time.
4. Prints the kernels' record as one JSON line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so it does without a CUDA device, or without the repository around it.
"""
import atexit
import dataclasses
import gc
import inspect
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 op/s
#: outside the tensor cores, dense bfloat16 op/s on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

N_RANKS = 4
WINDOW_ELEMS = 1 << 20        # one rank's window shard: 4 MiB of float32
K1_PAST_L2 = 1 << 23          # K1's second timed shape: 403 MB, past L2
ATOMIC_COUNT = 8              # at the default crossover: the intrinsic path
# the P5 tour: each rank's dynamic pool 2^24 float32 (64 MiB, 256 MiB in
# all); puts of 8, 2^10 and 2^20 floats (paper Fig. 12's axis)
P5_POOL = 1 << 24
P5_SIZES = (8, 1 << 10, 1 << 20)
STEPS = 4
GLOBAL_BATCH, SEQ_LEN = 8, 512
N_LAYERS = 2                  # depth cut for one card; every width is full
# llama4-maverick at full width: 2 of 48 layers (one dense + one MoE layer,
# a whole interleave period) and 8 of 128 experts, 2 on each of 4 stacked
# expert-parallel ranks — the share of 4 chips of a 64-chip expert layer
MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_EXPERTS, EP_RANKS, MOE_STEPS = 8, 4, 4
A2A_PHASES = 16               # the JAX planner's count at n = 4 (CPU tests)
# serving: qwen3-4b at all 36 layers and published widths, 8 requests over
# 4 slots.  Prompts are 1016 tokens (1024 - 8): one ending mid-page is what
# lets a copy-on-write fork happen at 16-token pages; K7 runs them at the
# 1024 its 128 blocks pad to.  Four share a 512-token prefix, two of those
# are the same prompt (their boundary page is shared copy-on-write).
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_PAGE = 4, 2048, 16
SERVE_REQUESTS, SERVE_PROMPT, SERVE_PREFIX, SERVE_NEW = 8, 1016, 512, 32
# the tiered pool: the [serve] phase's model, parameters and requests, with
# kv_pages=(2 x 128, 4 x 128) pages of 16 tokens: two sequences in HBM, four
# in the pinned host tier; the all-HBM paged engine it is held to runs the
# first 4 requests at the same HBM pool (enough to fill it)
TIER_SEQS = (2, 4)
TIER_HBM_REQUESTS = 4
# disaggregated prefill -> decode: the [serve] prompts' pages pushed over 8
# stacked ranks on a ring, 2 sequences a rank on 2 lanes (the reference
# demo's shape); the cross-stream check spins the push's stream this many
# cycles (~0.2 s at the H100's 1.98 GHz boost), doubled on each of at most
# TOKEN_SPIN_TRIES tries while the host issues the edge too late
DISAGG_RANKS, DISAGG_SEQS = 8, 2
TOKEN_SPIN_CYCLES, TOKEN_SPIN_TRIES = 400_000_000, 4
# the elastic runtime: worker 1 of 2 (slots 2 and 3) dies at tick 4
ELASTIC_SCRIPT = "dead:1@4"
#: K7 against its plain version: the JAX kernel test's tolerances
K7_TOL = {"float32": dict(atol=2e-5, rtol=1e-2),
          "bfloat16": dict(atol=2e-2, rtol=1e-2)}
#: a 36-layer bfloat16 prefill on K7 against the same prefill on K7's plain
#: version: max |d logit| over max |logit| (each layer's attention output
#: rounds to bfloat16, ~2^-8 relative, and the differences pass 36 layers)
PREFILL_LOGIT_RTOL = 5e-2
# serving a Mamba2 stack: mamba2-370m at all 48 layers and published widths,
# 8 requests of 2040-token prompts over 4 slots, 32 new tokens each.  2040
# is no multiple of the 64-token chunk: K8 and the pass take the ragged last
# chunk (56 rows) unpadded in every prefill
SSM_ARCH = "mamba2-370m"
SSM_SLOTS, SSM_MAX_SEQ, SSM_REQUESTS, SSM_PROMPT, SSM_NEW = 4, 4096, 8, 2040, 32
#: K8 against its plain version.  float32: the JAX kernel test's tolerance
#: (tests/test_kernels.py:148-181).  bfloat16 inputs: both sum in float32
#: (the kernel's hi/lo products keep ~2^-16) and round y_intra to bf16
#: once, so y may differ by one bf16 step (at most 2^-7 of |y|); states and
#: cum stay float32 and keep the float32 tolerance
K8_TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
          "bfloat16": dict(atol=1e-3, rtol=2.0**-7)}
#: the SSD pass (and the whole card scan) against its plain version at
#: bfloat16, y only: y = bf16(y_intra + bf16(y_inter)) rounds twice from
#: y_inter values ~2^-16 apart, and y_intra may itself be one step apart
#: (K8_TOL), so each rounding may land one bf16 step (2^-7 of the value
#: rounded) apart: |d| <= atol + 2^-6 (|y_intra| + |y_inter|)
PASS_BF16_RTOL = 2.0 ** -6
# serving the hybrid stack: jamba-v0.1-52b at published widths, depth cut
# to one period (8 of 32 layers: 7 Mamba2, 1 attention, 4 MoE, all 16
# experts), the [serve] request set through a dense and a paged + COW
# engine.  Its Mamba2 layers are 128 heads x 64 with d_state 16: K8 and the
# pass are held to their plain versions at that shape first
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 8
# the last three families, each after [serve-hybrid] on the card freed of
# the phase before.  deepseek-v2-236b (MLA) at published widths, depth cut
# to 4 of 60 layers (layer 0 dense, 3 MoE of all 160 experts: 13.30 B
# parameters, 49.6 GiB) or to 3 where the free memory cannot hold 4, the
# [serve] request set through the dense engine (its latent cache is not
# paged); internvl2-1b at all 24 layers, the [serve] request set dense and
# paged + COW, and one prefill with a 256-position patch prefix;
# whisper-base at 6 + 6 layers, 4 rows of 1500 frame embeddings (the 30 s
# encoder window), a 128-token decoder prompt, 32 greedy decode steps
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 4
VLM_ARCH = "internvl2-1b"
ENCDEC_ARCH = "whisper-base"
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 4, 1500, 128, 32
# SSM training: mamba2-370m at all 48 layers, 4 stacked data-parallel
# ranks with the one-sided ring, batch 8 x 512, 3 steps
SSM_TRAIN_STEPS = 3
# checkpoint / preemption / resume: mamba2-370m at published widths cut to 8
# of 48 layers, the [train-ssm] ring and batch; 6 steps saving every 2 (2
# kept), preempted at step 4 and resumed.  The resumed losses are held to
# the uninterrupted run's relatively: two runs on the card differ in the
# last bits (the embedding's backward adds with atomics); on the CPU they
# are equal bit for bit (tests/test_torch_ckpt.py)
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, CKPT_KEEP, CKPT_FAIL_AT = 8, 6, 2, 2, 4
CKPT_LOSS_RTOL = 1e-3
# the compressed all-reduce at mamba2-370m's gradient size (all 48 layers)
SSM_PARAMS = 368_494_080
#: a 48-layer bfloat16 Mamba2 prefill on K8 and the pass against the same
#: prefill on their plain versions: max |d logit| over max |logit| (each
#: layer's y rounds to bfloat16 in both, so entries may differ by one bf16
#: step, ~2^-8 relative, and the differences pass 48 layers — K7's bound
#: and reasoning)
SSM_LOGIT_RTOL = 5e-2
# the plan backends ([backends]): each backend's run takes as many steps
# as the [train] run it is held to (the learning-rate schedule spans the
# run), from the same seeds; the qwen3-4b gradient sum under "gspmd" adds
# the 4 rows in another order than K5's ring, so its later losses are held
# to the ring's relatively (float32 sums of 4 terms reassociate by a few
# ulps; AdamW carries that into the next loss)
BACKEND_LOSS_RTOL = 1e-3
# the walker's ring, informational: (4, 2^24) float32 (its gathered and
# placed copies of the whole gradient would not fit beside it)
INTERPRET_ELEMS = 1 << 24
# the dry-run: the full sweep (every arch x shape, both production meshes
# from one meta run a cell) runs in a CPU-only subprocess beside the card
# phases; [dryrun-card] holds the dry-run of the [train] configuration
# (qwen3-4b x2, batch 8 x 512, bf16 parameters and compute) against the
# card: 3 timed steps on a 1 x 1 mesh (gspmd), 2 ring steps on a 4 x 1 mesh
DRYRUN_TIMEOUT_S = 900
DRYRUN_CARD_STEPS, DRYRUN_RING_STEPS = 3, 2
#: [examples]: the kernels each example's run on the card must launch.
#: quickstart: the ordered put + signal (K4), its thread flush (K3's wait),
#: the planned ring all-reduce (K5); rma_patterns: puts (K3), intrinsic
#: accumulates (K2), put + signal pairs (K4), the fused accumulate + signal
#: (K6), flushes, the ring (K5); serve_decode: every prefill (K7) and the
#: paged window's handle put and flush (guarded K3, its wait); train_lm:
#: none (a dense step with the gspmd sync: no RMA kernel, and training
#: attention is blockwise, as in the JAX package)
EXAMPLE_KERNELS = {
    "quickstart": ("put_signal", "put_wait", "ring_all_reduce"),
    "rma_patterns": ("ring_put", "put_wait", "ring_accumulate", "put_signal",
                     "accumulate_signal", "ring_all_reduce"),
    "serve_decode": ("flash_attention", "ring_put", "put_wait"),
    "train_lm": (),
}
#: the caching allocator's block: a request is rounded up to 512 bytes, and
#: a segment's tail under 1 MiB stays with the block it was cut for
ALLOC_BLOCK, ALLOC_SPLIT_MIN = 512, 1 << 20


def bound_ms(nbytes: float, ops: float = 0.0,
             peak: float = PEAK_F32) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_work(length: int, heads: int, headdim: int, d_state: int,
             chunk: int) -> tuple[float, float, float, float]:
    """Bytes and operations of K8 and of the SSD pass on one bf16 sequence
    of ``length`` rows (a multiple of ``chunk``), no initial state.  K8:
    x, a, B, C read once; y, the float32 states and cum written once; the
    causal (i >= j) pairs of C B^T and of the y product, and every term of
    the states product.  The pass: the states, y_intra, C and cum read
    once, y and the final state written once; the read-out C_t . carry for
    every row and the carry update, once a chunk."""
    nc = length // chunk
    pairs = nc * chunk * (chunk + 1) // 2
    hp = heads * headdim
    states = 4 * nc * hp * d_state
    k8_bytes = (2 * 2 * length * hp + 4 * length * heads
                + 2 * 2 * length * d_state + states + 4 * length * heads)
    k8_ops = 2 * (pairs * d_state + pairs * hp + length * hp * d_state)
    pass_bytes = (states + 2 * length * hp + 2 * length * d_state
                  + 4 * length * heads + 2 * length * hp + 2 * hp * d_state)
    pass_ops = 2 * length * hp * d_state + 2 * nc * hp * d_state
    return k8_bytes, k8_ops, pass_bytes, pass_ops


def time_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Card time of one ``fn()``: ``reps`` calls captured in one CUDA graph
    and the graph replayed, so no host work falls between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up, off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def empty_launch(torch, *, programmatic: bool) -> None:
    """Launch a kernel that does nothing (``csrc/probes.cu``), the way the
    flush wait (``True``) or a plain launch such as K2 (``False``) is
    launched: the launch floor beside their byte bounds.  Counts nowhere."""
    from repro_torch import _build
    from repro_torch.kernels import common

    common.check_launch("empty", _build.lib("probes", "rt_empty")(
        int(programmatic), common.stream_ptr(torch.device("cuda"))))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_card(torch, dev, smi, n, K, get_config, path_counts) -> None:
    """[dryrun-card]: the dry-run of the [train] configuration held against
    the card.  On a 1 x 1 mesh (gspmd): its argument bytes are what the
    allocator is asked for when the same parameters, optimizer state and
    batch are made on the card (each rounded up to the allocator's block:
    what ``memory_allocated`` grows by, but for segment tails under 1 MiB
    the allocator keeps with their block); its meta run's dot FLOPs are
    ``FlopCounterMode``'s count of one real step; the step's measured ms
    beside the roofline's terms, the MFU, the predicted peak beside
    ``max_memory_allocated``.  On a 4 x 1 mesh (rma_ring): the ring's
    predicted phases are the card step's ledger, and K5 launches once a
    step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step
    from repro_torch.tree import leaves

    shape = ShapeConfig("train_8x512", SEQ_LEN, GLOBAL_BATCH, "train")
    over = {"n_layers": N_LAYERS}
    t0 = time.perf_counter()
    rec1 = DR.run_cell("qwen3-4b", shape, cfg_overrides=over,
                       mesh=make_host_mesh())
    rec4 = DR.run_cell("qwen3-4b", shape, cfg_overrides=over,
                       grad_sync="rma_ring", mesh=make_host_mesh(data=n))
    dry_s = time.perf_counter() - t0
    check(rec1["status"] == "ok" and rec4["status"] == "ok",
          "[dryrun-card] a cell failed")
    for rec in (rec1, rec4):
        print(DR.cell_line(f"qwen3-4b x{N_LAYERS} x {shape.name} x "
                           f"{rec['mesh']} ({rec['grad_sync']})", rec),
              flush=True)
    cfg = get_config("qwen3-4b").replace(n_layers=N_LAYERS,
                                         dtype="bfloat16",
                                         param_dtype="bfloat16")
    model = build_model(cfg)

    # the arguments, made on the card
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stats0 = torch.cuda.memory_stats()
    params = model.init(0, device=dev)
    opt_state = init_opt_state(params)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (GLOBAL_BATCH, SEQ_LEN),
                              generator=gen).to(dev, torch.int32)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    stats1 = torch.cuda.memory_stats()
    made = leaves(params) + leaves(opt_state) + list(batch.values())
    nbytes = [t.numel() * t.element_size() for t in made]
    blocks = [-(-b // ALLOC_BLOCK) * ALLOC_BLOCK for b in nbytes]
    requested = (stats1["requested_bytes.all.current"]
                 - stats0["requested_bytes.all.current"])
    allocated = (stats1["allocated_bytes.all.current"]
                 - stats0["allocated_bytes.all.current"])
    args = rec1["bytes_per_device"]["arguments"]
    check(args == sum(nbytes),
          f"[dryrun-card] arguments {args} != the card tensors' "
          f"{sum(nbytes)} bytes")
    check(requested == args,
          f"[dryrun-card] the allocator was asked for {requested} bytes, "
          f"the dry-run predicts {args}")
    check(sum(blocks) <= allocated < sum(blocks) + ALLOC_SPLIT_MIN * len(made),
          f"[dryrun-card] memory_allocated grew {allocated} bytes against "
          f"{sum(blocks)} in 512-byte blocks")
    print(f"[dryrun-card] arguments: dry-run {args} bytes = allocator "
          f"requests {requested} bytes exactly ({len(made)} tensors); "
          f"memory_allocated grew {allocated} = {sum(blocks)} in 512-byte "
          f"blocks + {allocated - sum(blocks)} of segment tails kept whole "
          f"(dry-run {dry_s:.1f} s for both cells)", flush=True)

    # one real step under the FLOP counter, then timed steps without it
    step = make_train_step(model, OptimizerConfig())
    with FlopCounterMode(display=False) as fc:
        step(params, opt_state, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    meta_flops = rec1["hlo_flops"] * rec1["chips"]
    check(card_flops == meta_flops,
          f"[dryrun-card] the card step's dot FLOPs {card_flops} != the "
          f"meta run's {meta_flops}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step_ms = []
    for _ in range(DRYRUN_CARD_STEPS):
        t1 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    best = min(step_ms[1:])
    roof = rec1["roofline"]
    mfu = rec1["model_flops"] / (best * 1e-3 * HA.PEAK_FLOPS)
    pred_peak = rec1["bytes_per_device"]["peak"]
    print(f"[dryrun-card] dot FLOPs: meta run {meta_flops:.6g} = card step "
          f"{card_flops:.6g} exactly; step ms {[round(v, 1) for v in step_ms]}"
          f" (host clock, synchronized) beside compute_s "
          f"{roof['compute_s'] * 1e3:.2f} ms and memory_s "
          f"{roof['memory_s'] * 1e3:.2f} ms (dominant {roof['dominant']}); "
          f"MFU {mfu:.4f} (model FLOPs {rec1['model_flops']:.6g} over "
          f"{best:.1f} ms at {HA.PEAK_FLOPS:.3g} FLOP/s, {smi}); peak: "
          f"predicted {pred_peak / 2**30:.2f} GiB (arguments "
          f"{args / 2**30:.2f} + transient {rec1['bytes_per_device']['temp'] / 2**30:.2f}) "
          f"vs max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({pred_peak / peak:.3f} x; {base / 2**30:.2f} GiB held before "
          f"the steps)", flush=True)

    # the ring over 4 stacked ranks: predicted phases = the card's ledger
    ring_step = make_train_step(model, OptimizerConfig(),
                                grad_sync="rma_ring", data_axis="data",
                                data_axis_size=n)
    coll = rec4["collectives"]
    check(coll is not None and coll["ranks"] == n,
          "[dryrun-card] the ring cell has no ring")
    K.reset_launch_counts()
    ledgers = []
    for _ in range(DRYRUN_RING_STEPS):
        _, _, metrics = ring_step(params, opt_state, batch)
        ledgers.append(metrics["phases"])
    torch.cuda.synchronize()
    counts = path_counts("[dryrun-card] ring step", ("ring_all_reduce",))
    check(counts["ring_all_reduce"] == DRYRUN_RING_STEPS,
          "[dryrun-card] K5 did not run once a step")
    check(all(p == coll["phases"] for p in ledgers),
          f"[dryrun-card] the card's ledgers {ledgers} != the dry-run's "
          f"{coll['phases']} phases")
    print(f"[dryrun-card] ring on {n} ranks: predicted {coll['phases']} "
          f"phases ({coll['phase_table']}) = the card's ledger {ledgers} a "
          f"step; K5 {counts['ring_all_reduce']} in {DRYRUN_RING_STEPS} "
          f"steps; ring bytes a rank {coll['total_bytes']:.6g}, "
          f"collective_s {rec4['roofline']['collective_s'] * 1e3:.3f} ms "
          f"at NVLink's {HA.NVLINK_BW:.3g} B/s", flush=True)
    del params, opt_state, batch, made, step, ring_step
    gc.collect()
    torch.cuda.empty_cache()


def collect_dryrun(proc, log, out_path, t0, get_config) -> None:
    """[dryrun]: wait for the sweep, print its lines, and hold its records:
    every runnable cell ``ok`` on both meshes, ``long_500k`` on a
    full-attention stack ``skipped`` with the reference's reason."""
    from repro_torch.configs import SHAPES, cell_is_runnable, list_archs
    from repro_torch.launch.dryrun import cell_line

    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("[dryrun] the sweep did not end in "
                             f"{DRYRUN_TIMEOUT_S} s")
    log.close()
    wall = time.perf_counter() - t0
    with open(log.name) as f:
        tail = [ln for ln in f.read().splitlines()
                if ln.startswith("[dryrun] done")]
    recs = [json.loads(ln) for ln in open(out_path)]
    check(rc == 0, f"[dryrun] the sweep exited {rc}: {tail}")
    by_cell = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    for arch in list_archs():
        for shape in sorted(SHAPES):
            ok, why = cell_is_runnable(get_config(arch), SHAPES[shape])
            for mesh in ("16x16", "2x16x16"):
                r = by_cell.get((arch, shape, mesh))
                check(r is not None, f"[dryrun] no record of {arch} x "
                      f"{shape} x {mesh}")
                want = "ok" if ok else "skipped"
                check(r["status"] == want, f"[dryrun] {arch} x {shape} x "
                      f"{mesh}: {r['status']} ({r.get('error')})")
                check(ok or r["why"] == why, f"[dryrun] {arch} x {shape}: "
                      f"skip reason {r.get('why')!r}")
                print(cell_line(f"{arch} x {shape} x {mesh}", r),
                      flush=True)
    print(f"[dryrun] {len(recs)} cells, 0 failures; {tail[-1]}; "
          f"{wall:.1f} s wall beside the card phases", flush=True)


class _Tee:
    """stdout that also keeps what was written (an example's lines are
    printed and searched for its marker)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def load_script(name: str, folder: str = "examples_torch"):
    """``<folder>/<name>.py`` as a module (the directory is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", os.path.join(HERE, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch, smi, K, path_counts) -> None:
    """[examples]: the four examples' ``main()`` with their default
    arguments (the card), in this process, each with every launch counter
    at 0 just before it; each must print its marker, and its own asserts
    fail the smoke.  ``rma_patterns``'s ledger counts on the card must
    equal its counts from a ``--device cpu`` run in this process."""
    import contextlib
    import io

    patterns = load_script("rma_patterns")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_counts = patterns.main(["--device", "cpu"])
    train_lm = load_script("train_lm")
    ckpt_dir = os.path.join(tempfile.gettempdir(),
                            "repro_torch_train_lm_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    for name, mod, marker, must in (
            ("quickstart", load_script("quickstart"), "QUICKSTART OK",
             EXAMPLE_KERNELS["quickstart"]),
            ("rma_patterns", patterns, "RMA_PATTERNS OK",
             EXAMPLE_KERNELS["rma_patterns"]),
            ("serve_decode", load_script("serve_decode"), "SERVE_DECODE OK",
             EXAMPLE_KERNELS["serve_decode"]),
            ("train_lm", train_lm, "TRAIN_LM OK",
             EXAMPLE_KERNELS["train_lm"])):
        K.reset_launch_counts()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            out = mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(marker in tee.text(), f"[examples] {name}: no {marker!r} line")
        counts = path_counts(f"[examples] {name}", must)
        launched = {k: v for k, v in counts.items() if v}
        print(f"[examples] {name}: {wall:.2f} s wall, launches by kernel "
              f"{launched} ({smi})", flush=True)
        if name == "rma_patterns":
            check(out == cpu_counts,
                  f"[examples] rma_patterns: card ledger {out} != the CPU "
                  f"run's {cpu_counts}")
            print(f"[examples] rma_patterns ledger on the card = the CPU "
                  f"run's: {out}", flush=True)
        if name == "train_lm":
            print(f"[examples] train_lm loss {out['first']:.4f} -> "
                  f"{out['last']:.4f} against the uniform baseline "
                  f"ln(vocab) = {out['uniform']:.4f} over 300 steps, "
                  f"{out['n_params'] / 1e6:.1f} M parameters, stragglers "
                  f"{out['stragglers']} ({smi})", flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as R
    from repro_torch.models import moe as moe_lib

    k1 = sys.modules["repro_torch.kernels.accumulate"]
    k2 = sys.modules["repro_torch.kernels.intrinsic"]
    k3 = sys.modules["repro_torch.kernels.rma_put"]
    k5 = sys.modules["repro_torch.kernels.ring_allreduce"]
    k46 = sys.modules["repro_torch.kernels.ordered_put_signal"]
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # [dryrun]: the full sweep on the meta device, in a subprocess that sees
    # no card, beside the card phases; collected before the record
    dry_dir = tempfile.mkdtemp(prefix="dryrun_")
    dry_out = os.path.join(dry_dir, "cells.jsonl")
    dry_log = open(os.path.join(dry_dir, "sweep.log"), "w")
    dry_t0 = time.perf_counter()
    dry_proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--both-meshes", "--out", dry_out], cwd=HERE, stdout=dry_log,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES=""))
    atexit.register(lambda: dry_proc.poll() is None and dry_proc.kill())
    for tag, name, kernel in (("K1", "accumulate", "acc_kernel"),
                              ("K5", "ring_allreduce", "ring_ar_kernel")):
        report = _build.ptxas_report(name, kernel)
        check(bool(report), f"no ptxas report of {tag}")
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in report if "Used " in line}, key=int)
        spills = {line.split(": ", 1)[1] for line in report
                  if "spill" in line}
        print(f"[ptxas] {tag}: {len(report) // 2} instance(s), registers "
              f"{', '.join(regs)}; {' | '.join(sorted(spills))}", flush=True)
    for tag, name, kernel in (("K8", "ssd_scan", "ssd_intra"),
                              ("K8 pass", "ssd_pass", "ssd_pass_kernel")):
        report = _build.ptxas_report(name, kernel)
        check(bool(report), f"no ptxas report of {tag}")
        for line in report:
            if "Used" in line or "spill" in line:
                entry, what = line.split(": ", 1)
                variant = ("bf16" if "bfloat16" in entry else "float32")
                print(f"[ptxas] {tag} {variant}: {what}", flush=True)
    k7_ptxas = _build.ptxas_report("flash_attention", "flash_fwd_wgmma")
    check(bool(k7_ptxas), "no ptxas report of K7's bfloat16 kernel")
    for line in k7_ptxas:
        print(f"[ptxas] K7 bf16 {line}", flush=True)
    smem_of = _build.lib("flash_attention", "rt_flash_attention_bf16_smem")
    print(f"[ptxas] K7 bf16 dynamic shared memory per CTA: {smem_of(128)} "
          f"bytes at head_dim 128, {smem_of(64)} at 64", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    record: dict[str, dict] = {}

    # ---- 1. every kernel against its plain version -------------------------
    def rand(shape, dtype):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device=dev).to(dtype)

    for dtype in (torch.float32, torch.int32):
        for op in k1.ACC_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            for m in (1, 4097, 1_000_003):
                b, u = rand((m,), dtype), rand((m,), dtype)
                want = k1.accumulate_plain(b.clone(), u, op=op)
                check(torch.equal(k1.accumulate(b, u, op=op), want),
                      f"K1 {op} {dtype} m={m}")
        for op in k2.ATOMIC_KERNEL_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            b, u = rand((N_RANKS, 64), dtype), rand((N_RANKS, 5), dtype)
            want = R.ring_accumulate_ref(b, u, axis_size=N_RANKS, op=op,
                                         offset=7)
            got = k2.ring_accumulate(u, b.clone(), axis_size=N_RANKS, op=op,
                                     offset=7)
            check(torch.equal(got, want), f"K2 {op} {dtype}")
        for shape in ((N_RANKS, 13), (8, 1001, 3)):
            x = rand(shape, dtype)
            check(torch.equal(k3.ring_put(x, axis_size=shape[0]),
                              R.ring_put_ref(x, axis_size=shape[0])),
                  f"K3 {shape} {dtype}")
    for dtype in (torch.float64, torch.float16, torch.bfloat16, torch.int64):
        for op in k1.ACC_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            for m in (1, 4097, 1_000_003):
                b, u = rand((m,), dtype), rand((m,), dtype)
                want = k1.accumulate_plain(b.clone(), u, op=op)
                check(torch.equal(k1.accumulate(b, u, op=op), want),
                      f"K1 {op} {dtype} m={m}")
    # odd-offset (misaligned) column slices of a wider window: the scalar
    # path where the two rows' offsets differ, the scalar head where the
    # buffer's row stride moves each row's offset
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.int32):
        for op in k1.ACC_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            for off, width in ((1, 4099), (3, 65536), (8, 70001)):
                win = rand((N_RANKS, width + off + 5), dtype)
                u = rand((N_RANKS, width), dtype)
                want = win.clone()
                k1.accumulate_plain(want[:, off:off + width], u, op=op)
                k1.accumulate_rows(win[:, off:off + width], u, op=op)
                check(torch.equal(win, want),
                      f"K1 {op} {dtype} column slice at {off}")
    # K5 at fixed ragged shapes, then 40 random ones (rank counts 2-8,
    # lengths up to 2^24: scalar and vector paths, from a few agents to
    # every resident block with several tiles an agent), so the kernel's
    # own schedules meet the ring's waits
    pick = random.Random(0)
    shapes = [(2, 6), (N_RANKS, 13), (8, 1000), (3, 3001)] + [
        (pick.choice((2, 3, 4, 5, 8)), int(2 ** pick.uniform(0, 24)))
        for _ in range(40)]
    for n, length in shapes:
        x = rand((n, length), torch.float32)
        want = k5.ring_all_reduce_plain(
            torch.cat([x, x.new_zeros((n, (-length) % n))], 1))[:, :length]
        check(torch.equal(k5.ring_all_reduce(x, axis_size=n), want),
              f"K5 {n}x{length}")
    print("[kernels] K1/K2/K3/K5 equal their plain versions: every op, "
          "float32/int32 (K1 also float64/float16/bfloat16/int64, and "
          f"misaligned column slices), ragged tails; K5 at {len(shapes)} "
          "shapes", flush=True)

    # K4 / K6: ordered and Listing-1, every dtype of the paths and every K6
    # op, ragged tails and the all-to-all's own blocks (Cp x (d+1) bf16)
    cfg_moe = get_config(MOE_ARCH)
    d_model = cfg_moe.d_model
    tokens_rank = GLOBAL_BATCH * SEQ_LEN // EP_RANKS
    cp = moe_lib._pair_capacity(cfg_moe.moe, tokens_rank, EP_RANKS)
    a2a_block = (N_RANKS, cp, d_model + 1)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for shape in ((N_RANKS, 13), (8, 1001, 3), (3, 1), a2a_block):
            n_ = shape[0]
            x = rand(shape, dtype)
            for ordered in (True, False):
                f = rand((n_, 2), dtype)
                got = k46.put_signal(x, f, axis_size=n_, ordered=ordered)
                want = k46.put_signal(x.cpu(), f.cpu(), axis_size=n_,
                                      ordered=ordered)
                check(torch.equal(got[0].cpu(), want[0])
                      and torch.equal(got[1].cpu(), want[1]),
                      f"K4 {dtype} {shape} ordered={ordered}")
            if shape == a2a_block and dtype != torch.bfloat16:
                continue
            for op in k46.ATOMIC_KERNEL_OPS:
                if op in k1.BITWISE_OPS and dtype.is_floating_point:
                    continue
                b = rand((n_, shape[1] + 5) + shape[2:], dtype)
                f = rand((n_, 1), dtype)
                for ordered in (True, False):
                    got = k46.accumulate_signal(x, b, f, axis_size=n_, op=op,
                                                offset=3, ordered=ordered)
                    want = k46.accumulate_signal(
                        x.cpu(), b.cpu(), f.cpu(), axis_size=n_, op=op,
                        offset=3, ordered=ordered)
                    check(torch.equal(got[0].cpu(), want[0])
                          and torch.equal(got[1].cpu(), want[1]),
                          f"K6 {op} {dtype} {shape} ordered={ordered}")
    # the ordering check, in the copy unit and launch mode of the launch it
    # checks: at the a2a block the dispatch's own 16-byte copy, ordered
    # (plain launch) and Listing 1 (cooperative)
    ring_t = [(r + 1) % N_RANKS for r in range(N_RANKS)]
    mismatched, units = {}, {}
    for shape, dtype in ((a2a_block, torch.bfloat16), ((N_RANKS, 4097),
                                                       torch.int32)):
        x = rand(shape, dtype)
        for ordered in (True, False):
            dst = torch.zeros_like(x)
            fl = torch.zeros((N_RANKS, 4), dtype=torch.int32, device=dev)
            bad = torch.zeros(1, dtype=torch.int32, device=dev)
            k46.put_signal_rows(x, dst, ring_t,
                                flag=torch.ones((N_RANKS, 1),
                                                dtype=torch.int32),
                                flag_dst=fl, flag_offset=2, ordered=ordered,
                                check=bad)
            mismatched[(shape, ordered)] = bad.item()
            units[shape] = k46.copy_unit(x, dst)
            check(torch.equal(dst, torch.roll(x, 1, 0)),
                  f"K4 check mode {shape} landed wrong")
    check(units[a2a_block] == 16, f"K4 copies the a2a block in "
          f"{units[a2a_block]}-byte units, not 16")
    check(not any(mismatched.values()),
          f"K4 ordering check: units read behind a raised flag differ "
          f"{mismatched}")
    print(f"[kernels] K4/K6 equal their plain versions: ordered and "
          f"unordered, float32/bfloat16/int32, every K6 op, ragged tails, "
          f"the a2a block {list(a2a_block)}; ordering check mismatched units "
          f"{sum(mismatched.values())} (copy units in bytes: "
          f"{ {str(list(k)): v for k, v in units.items()} })", flush=True)

    # main-path shapes: the window tour's (K1, K2, K3) and the gradient
    # ring's (K5)
    n, M = N_RANKS, WINDOW_ELEMS
    win_buf, upd = rand((n, M), torch.float32), rand((n, M), torch.float32)
    want = win_buf + torch.roll(upd, 1, 0)
    got = win_buf.clone()
    k1.accumulate_rows(got, torch.roll(upd, 1, 0), op="sum")
    check(torch.equal(got, want), "K1 at the window shape")
    err = (got - want).abs().max().item()
    landed = torch.roll(upd, 1, 0)
    record["accumulate"] = dict(
        ms=graph_ms(torch, lambda: k1.accumulate_rows(got, landed, op="sum")),
        call_ms=time_ms(torch, lambda: k1.accumulate_rows(got, landed,
                                                          op="sum")),
        plain_ms=graph_ms(torch, lambda: k1.accumulate_plain(got, landed,
                                                             op="sum")),
        library_ms=graph_ms(torch, lambda: got.add_(landed)),
        max_abs_err=err, shape=[n, M], dtype="float32")
    record["accumulate"]["bound_ms"], record["accumulate"]["bound_by"] = \
        bound_ms(3 * n * M * 4, n * M)
    # the same accumulate past the 50 MB L2: (4, 2^23) float32, 403 MB moved
    big_buf, big_upd = rand((n, K1_PAST_L2), torch.float32), \
        rand((n, K1_PAST_L2), torch.float32)
    want = big_buf + big_upd
    k1.accumulate_rows(big_buf, big_upd, op="sum")
    check(torch.equal(big_buf, want), "K1 past L2")
    record["accumulate"]["past_l2"] = dict(
        shape=[n, K1_PAST_L2],
        ms=graph_ms(torch, lambda: k1.accumulate_rows(big_buf, big_upd,
                                                      op="sum")),
        plain_ms=graph_ms(torch, lambda: k1.accumulate_plain(
            big_buf, big_upd, op="sum")),
        library_ms=graph_ms(torch, lambda: big_buf.add_(big_upd)),
        bound_ms=bound_ms(3 * n * K1_PAST_L2 * 4, n * K1_PAST_L2)[0])
    big = record["accumulate"]["past_l2"]
    print(f"[kernel] accumulate past L2 [{n}, {K1_PAST_L2}] float32: "
          f"{big['ms']:.4f} ms ({100 * big['bound_ms'] / big['ms']:.1f} % of "
          f"the {big['bound_ms']:.4f} ms bound), add_ {big['library_ms']:.4f},"
          f" plain {big['plain_ms']:.4f}", flush=True)
    del big_buf, big_upd, want

    small = rand((n, ATOMIC_COUNT), torch.float32)
    tgt = torch.tensor([(r + 1) % n for r in range(n)], dtype=torch.int32,
                       device=dev)      # the origin → target map, on the card
    want = R.ring_accumulate_ref(win_buf, small, axis_size=n, op="sum",
                                 offset=M - ATOMIC_COUNT)
    got = k2.ring_accumulate(small, win_buf.clone(), axis_size=n, op="sum",
                             offset=M - ATOMIC_COUNT)
    check(torch.equal(got, want), "K2 at the window shape")
    err = (got - want).abs().max().item()
    region = got[:, M - ATOMIC_COUNT:]
    tgt_t = tgt.long()
    record["ring_accumulate"] = dict(
        ms=graph_ms(torch, lambda: k2.accumulate_rows_atomic(
            small, got, tgt, op="sum", offset=M - ATOMIC_COUNT)),
        call_ms=time_ms(torch, lambda: k2.accumulate_rows_atomic(
            small, got, tgt, op="sum", offset=M - ATOMIC_COUNT), reps=50),
        plain_ms=graph_ms(torch, lambda: k2.accumulate_rows_atomic_plain(
            small, got, ring_t, op="sum", offset=M - ATOMIC_COUNT)),
        library_ms=graph_ms(torch, lambda: region.index_add_(0, tgt_t,
                                                             small)),
        max_abs_err=err, shape=[n, ATOMIC_COUNT], dtype="float32")
    record["ring_accumulate"]["bound_ms"], \
        record["ring_accumulate"]["bound_by"] = bound_ms(
            3 * n * ATOMIC_COUNT * 4, n * ATOMIC_COUNT)

    got, want = k3.ring_put(upd, axis_size=n), R.ring_put_ref(upd, axis_size=n)
    check(torch.equal(got, want), "K3 at the window shape")
    err = (got - want).abs().max().item()
    dst = torch.empty_like(upd)
    record["ring_put"] = dict(
        ms=graph_ms(torch, lambda: k3.put_rows(upd, dst, tgt)),
        call_ms=time_ms(torch, lambda: k3.put_rows(upd, dst, tgt)),
        plain_ms=graph_ms(torch, lambda: k3.put_rows_plain(upd, dst,
                                                           ring_t)),
        library_ms=graph_ms(torch, lambda: torch.roll(upd, 1, 0)),
        max_abs_err=err, shape=[n, M], dtype="float32")
    record["ring_put"]["bound_ms"], record["ring_put"]["bound_by"] = \
        bound_ms(2 * n * M * 4)

    # K3's flush half: the wait on one stream's counters, after the puts of
    # the window tour's shape (one tick per block each), met and short
    counters = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    ticks = k3.put_rows(upd, dst, tgt, counters=counters, stream=0)
    stalls = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    for owed in ([ticks] * n, [ticks, ticks + 1, ticks, ticks + 1]):
        k3.wait_counters(counters, owed, stream=0, stalls=stalls[0])
        k3.wait_counters_plain(counters, owed, stream=0, stalls=stalls[1])
    check(stalls[0].item() == stalls[1].item() == 2,
          f"K3 wait found {stalls[0].item()} ranks short, plain "
          f"{stalls[1].item()}, of 2")
    err = float(abs(stalls[0].item() - stalls[1].item()))
    owed = [ticks] * n
    # the plain wait copies the owed counts to the card from the host, which
    # a graph cannot capture: it is timed by calls
    record["put_wait"] = dict(
        ms=graph_ms(torch, lambda: k3.wait_counters(
            counters, owed, stream=0, stalls=stalls[0])),
        call_ms=time_ms(torch, lambda: k3.wait_counters(
            counters, owed, stream=0, stalls=stalls[0]), reps=50),
        plain_ms=time_ms(torch, lambda: k3.wait_counters_plain(
            counters, owed, stream=0, stalls=stalls[1]), reps=50),
        library_ms=None, max_abs_err=err, shape=[n, 2], dtype="int32")
    record["put_wait"]["bound_ms"], record["put_wait"]["bound_by"] = \
        bound_ms(4 * n + 4, n)
    check(stalls[0].item() == 2, "K3 wait stalled on met counts")

    # stream order across a flush that does not own the put before it: a
    # window puts a little on flush stream 0, then 2^24 floats a rank on
    # stream 1, flushes stream 0 (its wait, launched programmatically right
    # behind the big put, finds its counts met at once) and overwrites the
    # big put's source with an ordinary kernel; what landed must be the
    # source as it was
    from repro_torch.core.rma.substrate import Substrate
    ring = [(r, (r + 1) % n) for r in range(n)]
    order_sub = Substrate.allocate(
        torch.zeros((n, P5_POOL), dtype=torch.float32, device=dev), "x", n,
        n_streams=2)
    for _ in range(3):
        big_src = rand((n, P5_POOL), torch.float32)
        want = torch.roll(big_src, 1, 0)
        order_sub.put(big_src[:, :8], ring, stream=0)
        order_sub.put(big_src, ring, stream=1)
        order_sub.flush(scope="thread", stream=0)
        big_src.fill_(-1.0)
        torch.cuda.synchronize()
        check(torch.equal(order_sub.buffer, want),
              "a put overlapped the kernel queued after another stream's "
              "flush")
        order_sub.flush(scope="thread", stream=1)
    check(order_sub.completion_ok(), "the ordering check's puts stalled")
    del order_sub, big_src, want
    print("[kernel] stream order holds across a thread flush of another "
          "stream: 3 of 3 (4, 2^24) float32 puts landed intact", flush=True)

    # ---- K3's and K2's P5 variants: the address from device memory ------
    # each against its plain version on the same card tensors: per-origin
    # displacements (one past the row, one negative: placed as lax places
    # them), fresh and stale memory handles (the guard drops a put, zeroes a
    # read, and counts either at the target), every K2 op and dtype
    regs_c = torch.zeros((n, 3, 3), dtype=torch.int32, device=dev)
    regs_c[:, 1, 0] = 5
    regs_c[2, 1, 0] = 6                  # rank 2 re-registered: stale there
    hnd_c = torch.tensor([[5, 2, 0, 1]] * n, dtype=torch.int32, device=dev)
    # per-rank slot words: rank 0's handle names slot 2 (live epoch 7), the
    # others' slot 1 (5); the guard takes the addressed rank's own slot, so
    # on the ring only the operation whose window is rank 0's goes stale
    regs_s = regs_c.clone()
    regs_s[2, 1, 0] = 5
    regs_s[:, 2, 0] = 7
    hnd_s = hnd_c.clone()
    hnd_s[0, 3] = 2
    slot_err = [1] + [0] * (n - 1)
    variants = 0
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        for L, m in ((64, 5), (1 << 16, 1000), (M, M // 4)):
            big, small = rand((n, L), dtype), rand((n, m), dtype)
            disp = torch.tensor([0, 3, L - m + 7, -5], dtype=torch.int32,
                                device=dev)
            for kw in (dict(disp=disp), dict(disp=disp, handles=hnd_c),
                       dict(disp=disp, handles=hnd_c, regs=regs_c),
                       dict(handles=hnd_c, regs=regs_c, offset=4),
                       dict(disp=disp, handles=hnd_s, regs=regs_s)):
                for read in (False, True):
                    src, dst0 = (big, small) if read else (small, big)
                    outs = []
                    for fn in (k3.put_rows, k3.put_rows_plain):
                        d = dst0.clone()
                        e = (torch.zeros(n, dtype=torch.int32, device=dev)
                             if "regs" in kw else None)
                        fn(src, d, ring_t, read=read, err=e, **kw)
                        outs.append((d, e))
                    check(torch.equal(outs[0][0], outs[1][0]) and (
                        outs[0][1] is None
                        or torch.equal(outs[0][1], outs[1][1])),
                        f"K3 {'read' if read else 'put'} {dtype} ({L}, {m}) "
                        f"{sorted(kw)}")
                    check("regs" not in kw or outs[0][1].sum().item() == 1,
                          "K3's guard counted wrong")
                    check(kw.get("regs") is not regs_s
                          or outs[0][1].tolist() == slot_err,
                          f"K3's guard did not take the addressed rank's "
                          f"slot: {outs[0][1]}")
                    variants += 1
    for dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        for op in k2.ATOMIC_KERNEL_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            for m in (1, ATOMIC_COUNT, 13):
                b, u = rand((n, 64), dtype), rand((n, m), dtype)
                disp = torch.tensor([0, 4, 60, -3], dtype=torch.int32,
                                    device=dev)
                for kw in (dict(offset=3), dict(disp=disp),
                           dict(disp=disp, handles=hnd_c, regs=regs_c),
                           dict(disp=disp, handles=hnd_s, regs=regs_s)):
                    outs = []
                    for fn in (k2.accumulate_rows_atomic,
                               k2.accumulate_rows_atomic_plain):
                        e = torch.zeros(n, dtype=torch.int32, device=dev)
                        if "regs" in kw:
                            kw["err"] = e
                        outs.append((fn(u, b.clone(), ring_t, op=op, **kw), e))
                    check(torch.equal(outs[0][0], outs[1][0])
                          and torch.equal(outs[0][1], outs[1][1]),
                          f"K2 {op} {dtype} m={m} {sorted(kw)}")
                    check(kw.get("regs") is not regs_s
                          or outs[0][1].tolist() == slot_err,
                          f"K2's guard did not take the target's slot: "
                          f"{outs[0][1]}")
                    variants += 1
    print(f"[kernels] K3 and K2 with device displacements and the handle "
          f"guard equal their plain versions: {variants} cases (clamped and "
          f"negative rows, stale puts dropped, stale reads zeroed, counts "
          f"equal; handles whose slot word differs by rank checked against "
          f"the addressed rank's own slot)", flush=True)

    # the variants at the [p5] tour's shapes: a (4, 2^20) float32 put into
    # the (4, 2^24) dynamic pool, and K2's (4, 8) float32 sum, at per-rank
    # displacements (device) and through fresh handles (guarded)
    pool_t = rand((n, P5_POOL), torch.float32)
    offs_host = [0, P5_POOL // 4 + 4, P5_POOL // 2 + 8, P5_POOL - M]
    disp_t = torch.tensor(offs_host, dtype=torch.int32, device=dev)
    regs_t = torch.zeros((n, 2, 3), dtype=torch.int32, device=dev)
    regs_t[:, 0, 0] = 1
    hnd_t = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    hnd_t[:, 0] = 1
    hnd_t[:, 1] = disp_t
    err_t = torch.zeros(n, dtype=torch.int32, device=dev)
    upd = rand((n, M), torch.float32)
    small = rand((n, ATOMIC_COUNT), torch.float32)
    rows = tgt.long()                    # the receiver of each origin
    for name, addr, payload, kernel in (
            ("ring_put_device", dict(disp=disp_t), upd, "put"),
            ("ring_put_guarded", dict(handles=hnd_t, regs=regs_t, err=err_t),
             upd, "put"),
            ("ring_accumulate_device", dict(disp=disp_t), small, "acc"),
            ("ring_accumulate_guarded",
             dict(handles=hnd_t, regs=regs_t, err=err_t), small, "acc")):
        m = payload.shape[1]
        # the library call's flat index: receiver row, origin's displacement
        flat = (rows[:, None] * P5_POOL + disp_t.long()[:, None]
                + torch.arange(m, device=dev)).reshape(-1)
        if kernel == "put":
            def call(d, payload=payload, addr=addr):
                k3.put_rows(payload, d, tgt, **addr)

            def plain(d, payload=payload, addr=addr):
                k3.put_rows_plain(payload, d, ring_t, **addr)

            def lib(d, payload=payload, flat=flat):
                d.view(-1).index_copy_(0, flat, payload.reshape(-1))
            nbytes = 2 * n * m * 4
        else:
            def call(d, payload=payload, addr=addr):
                k2.accumulate_rows_atomic(payload, d, tgt, op="sum", **addr)

            def plain(d, payload=payload, addr=addr):
                k2.accumulate_rows_atomic_plain(payload, d, ring_t, op="sum",
                                                **addr)

            def lib(d, payload=payload, flat=flat):
                d.view(-1).index_add_(0, flat, payload.reshape(-1))
            nbytes = 3 * n * m * 4
        got, plain_got, lib_got = (pool_t.clone() for _ in range(3))
        call(got)
        plain(plain_got)
        lib(lib_got)
        check(torch.equal(got, plain_got), f"{name} at the tour's shape")
        check(torch.equal(lib_got, plain_got),
              f"{name}: the library call computes another function")
        check(err_t.sum().item() == 0, f"{name}: fresh handles counted")
        err = (got - plain_got).abs().max().item()
        record[name] = dict(
            ms=graph_ms(torch, lambda: call(got)),
            call_ms=time_ms(torch, lambda: call(got), reps=50),
            plain_ms=time_ms(torch, lambda: plain(plain_got), reps=5),
            library_ms=graph_ms(torch, lambda: lib(lib_got)),
            max_abs_err=err, shape=[n, m], dtype="float32")
        # the bytes moved, plus the per-origin words read (displacement, or
        # handle and the live registration entry)
        extra = 4 * n if "disp" in addr else 20 * n
        record[name]["bound_ms"], record[name]["bound_by"] = bound_ms(
            nbytes + extra, n * m if kernel == "acc" else 0.0)
    del pool_t, plain_got, lib_got

    # the launch floor beside K2's and the wait's byte bounds: an empty
    # kernel launched as each is (plainly, and programmatically serialized)
    floor = graph_ms(torch, lambda: empty_launch(torch, programmatic=False))
    floor_pdl = graph_ms(torch, lambda: empty_launch(torch,
                                                     programmatic=True))
    for name in ("ring_accumulate", "ring_accumulate_device",
                 "ring_accumulate_guarded"):
        record[name]["floor_ms"] = floor
    record["put_wait"]["floor_ms"] = floor_pdl
    # the put -> wait pair (the thread flush of one put), with the wait
    # launched programmatically or after the put ends; the counters reset in
    # each pair, so every replayed wait is a real completion test
    cnt_p = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    stall_p = torch.zeros(1, dtype=torch.int32, device=dev)
    pair = {}
    for size in P5_SIZES:
        x = upd[:, :size].contiguous()
        y = torch.empty_like(x)
        ticks = k3.put_rows(x, y, tgt, counters=cnt_p)
        row = {}
        for mode, prog in (("programmatic", True), ("serial", False)):
            def put_wait_pair(prog=prog):
                cnt_p.zero_()
                k3.put_rows(x, y, tgt, counters=cnt_p)
                k3.wait_counters(cnt_p, [ticks] * n, stream=0,
                                 stalls=stall_p, programmatic=prog)
            row[mode] = graph_ms(torch, put_wait_pair)
        row["put"] = graph_ms(torch, lambda: (
            cnt_p.zero_(), k3.put_rows(x, y, tgt, counters=cnt_p)))
        pair[size] = row
    check(stall_p.item() == 0, f"the put -> wait pairs stalled "
          f"{stall_p.item()} times")
    record["put_wait"]["pair_ms"] = pair
    record["put_wait"]["floor_serial_ms"] = floor
    print(f"[kernel] empty launch {floor:.4f} ms, programmatic {floor_pdl:.4f};"
          f" put -> wait pairs (ms, programmatic / serial / put alone): "
          + "; ".join(f"{s}: {r['programmatic']:.4f} / {r['serial']:.4f} / "
                      f"{r['put']:.4f}" for s, r in pair.items())
          + f"; stalls {stall_p.item()}", flush=True)
    del win_buf, upd, got, dst, landed, region

    # K3 on a pinned host window (the tiered KV pool's cold tier): a guarded
    # put into pinned host memory and a guarded read out of it, at one
    # qwen3-4b page payload (16 tokens x 8 KV heads x 128 x K,V x 36
    # layers, bf16), a ragged size at an odd offset and a stale handle,
    # each against its plain version bit for bit; timed beside copy_ of the
    # same bytes between the card and pinned memory
    from repro_torch.core import rma as rma_layer

    cfg_q = get_config("qwen3-4b")
    page_e = (SERVE_PAGE * cfg_q.n_kv_heads * cfg_q.head_dim * 2
              * cfg_q.n_layers)
    host_pool = torch.zeros((1, 4 * page_e), dtype=torch.bfloat16,
                            pin_memory=True)
    check(host_pool.is_pinned() and not host_pool.is_cuda,
          "the host pool is not pinned host memory")
    regs_h = torch.zeros((1, 4, 3), dtype=torch.int32, device=dev)
    regs_h[0, :, 0] = torch.tensor([1, 2, 4, 0], dtype=torch.int32)
    tgt_self = torch.zeros(1, dtype=torch.int32, device=dev)

    def handle_at(epoch, offset, slot):
        return torch.tensor([[epoch, offset, page_e, slot]],
                            dtype=torch.int32, device=dev)

    # a length past a whole number of the grid's strides (20,528 bytes: 2
    # blocks of 256 threads walk 8,192 bytes a step), 16-byte aligned
    steps_e = 5 * 2048 + 24
    host_cases = (("one page", page_e, handle_at(2, page_e, 1), 0),
                  ("ragged", page_e - 7, handle_at(1, 0, 0), 3),
                  ("stale", page_e, handle_at(3, 2 * page_e, 2), 0),
                  ("past whole strides", steps_e, handle_at(4, page_e, 2),
                   8))
    for what, m, hnd, off in host_cases:
        stale = what == "stale"
        payload = rand((1, m), torch.bfloat16)
        seed_pool = rand((1, 4 * page_e), torch.bfloat16).cpu()
        for read in (False, True):
            outs = []
            for fn in (k3.put_rows, k3.put_rows_plain):
                e = torch.zeros(1, dtype=torch.int32, device=dev)
                hp = torch.empty(host_pool.shape, dtype=torch.bfloat16,
                                 pin_memory=True).copy_(seed_pool)
                if read:
                    got = torch.full((1, m), 7, dtype=torch.bfloat16,
                                     device=dev)
                    fn(hp, got, tgt_self, offset=off, handles=hnd,
                       regs=regs_h, err=e, read=True)
                else:
                    fn(payload, hp, tgt_self, offset=off, handles=hnd,
                       regs=regs_h, err=e)
                    got = hp
                torch.cuda.synchronize()     # the card wrote host memory
                outs.append((got.cpu(), e.cpu()))
            check(torch.equal(outs[0][0], outs[1][0])
                  and torch.equal(outs[0][1], outs[1][1]),
                  f"K3 {'read' if read else 'put'} on a pinned host window "
                  f"({what}) differs from its plain version")
            check(outs[0][1].item() == int(stale),
                  f"K3 host {what}: counted {outs[0][1].item()}")
            if stale and read:
                check(not outs[0][0].any(), "a stale host read not zeroed")
            if stale and not read:
                check(torch.equal(outs[0][0], seed_pool),
                      "a stale put into host memory landed")
    check(K.COUNTERS["ring_put"].by_variant.get("guarded-host", 0) >= 8,
          "K3 did not launch on the pinned host window")
    unpinned = torch.zeros((1, 4 * page_e), dtype=torch.bfloat16)
    for what, call in (
            ("put", lambda: k3.put_rows(payload, unpinned, tgt_self,
                                        handles=handle_at(1, 0, 0),
                                        regs=regs_h)),
            ("window", lambda: rma_layer.Window.allocate(
                unpinned, "x", 1, device="cuda"))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"an unpinned CPU buffer beside card tensors "
                             f"did not raise ({what})")
    # one page each way, by graph replay, beside copy_ of the same bytes
    hnd = handle_at(2, page_e, 1)
    e_h = torch.zeros(1, dtype=torch.int32, device=dev)
    page = rand((1, page_e), torch.bfloat16)
    back = torch.empty_like(page)
    region_h = host_pool[:, page_e:2 * page_e]

    def host_put():
        k3.put_rows(page, host_pool, tgt_self, handles=hnd, regs=regs_h,
                    err=e_h)

    def host_read():
        k3.put_rows(host_pool, back, tgt_self, handles=hnd, regs=regs_h,
                    err=e_h, read=True)

    host_put()
    host_read()
    torch.cuda.synchronize()
    check(torch.equal(back, page) and e_h.item() == 0,
          "a page did not round-trip through the pinned host window")
    page_plain = host_pool.clone()
    k3.put_rows_plain(page, page_plain, tgt_self, handles=hnd, regs=regs_h)
    check(torch.equal(page_plain, host_pool), "K3 host put vs plain")
    def pcie_link() -> list:
        """The link's current generation and width, then the maximum ones,
        as nvidia-smi reads them (None where it says [N/A])."""
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
             "pcie.link.width.current,pcie.link.gen.max,"
             "pcie.link.width.max", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
        return [int(x) if x.strip().isdigit() else None
                for x in out.strip().splitlines()[0].split(",")]

    link_before = pcie_link()
    host_ms = dict(
        put=graph_ms(torch, host_put), read=graph_ms(torch, host_read),
        put_copy=graph_ms(torch, lambda: region_h.copy_(page,
                                                        non_blocking=True)),
        read_copy=graph_ms(torch, lambda: back.copy_(region_h,
                                                     non_blocking=True)))
    # what bounds the host path: a read's round trip, K3's loop over the
    # grid, a second pinned buffer (benchmarks_torch/host_link.py prints its
    # [host-link] lines)
    link = load_script("host_link", "benchmarks_torch").measure(
        torch, log=lambda line: print(line, flush=True))
    link_after = pcie_link()
    #: nominal GB/s a lane carries each way, by PCIe generation (encoding
    #: included: 8b/10b to gen 2, 128b/130b from gen 3)
    lane_gbs = {1: 0.25, 2: 0.5, 3: 0.985, 4: 1.969, 5: 3.938, 6: 7.563}
    gens = [g for g in (link_before[0], link_after[0]) if g]
    if gens and link_before[1]:
        link_gen, link_width = max(gens), link_before[1]
        link_src = (f"nvidia-smi: current gen {link_before[0]} before the "
                    f"timing, {link_after[0]} after; max gen {link_before[2]}"
                    f" x{link_before[3]}")
    else:           # the card's host interface, H100 SXM data sheet
        link_gen, link_width = 5, 16
        link_src = ("nvidia-smi reads the link as [N/A]; the H100 SXM data "
                    "sheet's host interface, PCIe gen5 x16")
    link_rate = lane_gbs[link_gen] * link_width * 1e9
    nbytes = page_e * 2
    blocks_h = k3.launch_blocks(nbytes)
    record["ring_put_host"] = dict(
        ms=host_ms["put"], read_ms=host_ms["read"],
        plain_ms=time_ms(torch, lambda: k3.put_rows_plain(
            page, page_plain, tgt_self, handles=hnd, regs=regs_h), reps=3),
        library_ms=host_ms["put_copy"], read_library_ms=host_ms["read_copy"],
        max_abs_err=0.0, shape=[1, page_e], dtype="bfloat16",
        bound_ms=nbytes / link_rate * 1e3, bound_by="bytes",
        link=f"PCIe gen{link_gen} x{link_width}, {link_rate / 1e9:.2f} "
             f"GB/s nominal each way ({link_src})",
        launch=dict(blocks=blocks_h,
                    inflight=blocks_h * k3.PUT_THREADS * 16),
        sweep_best=link["best"], latency_ns=link["latency_ns"]["host"])
    rh = record["ring_put_host"]
    print(f"[kernels] K3 on a pinned host window equals its plain version "
          f"bit for bit: put and read of one qwen3-4b page ({page_e} bf16), "
          f"a ragged {page_e - 7} at offset 3, a stale handle (put dropped, "
          f"read zeroed, each counted once), {steps_e} (past whole grid "
          f"strides); an unpinned CPU buffer beside card tensors raises.  "
          f"The launch: {blocks_h} blocks ({rh['launch']['inflight']} bytes "
          f"in flight).  One page by graph replay: put "
          f"{rh['ms']:.4f} ms ({nbytes / rh['ms'] / 1e6:.2f} GB/s), copy_ "
          f"to pinned {rh['library_ms']:.4f}; read {rh['read_ms']:.4f} ms "
          f"({nbytes / rh['read_ms'] / 1e6:.2f} GB/s), copy_ from pinned "
          f"{rh['read_library_ms']:.4f}; bound {rh['bound_ms']:.4f} ms on "
          f"{rh['link']}", flush=True)
    del host_pool, page, back, region_h, page_plain, unpinned, seed_pool

    # K4 at the dispatch's per-peer block, K6 at the combine's: (n, Cp,
    # d+1) and (n, Cp, d) bfloat16, the doorbell an int32 header word
    tgt_ring = torch.tensor(ring_t, dtype=torch.int32, device=dev)
    tgt_long = tgt_ring.long()
    hdr = torch.zeros((n, 2 * n), dtype=torch.int32, device=dev)
    bell = torch.ones((n, 1), dtype=torch.int32, device=dev)
    sig = dict(flag=bell, flag_dst=hdr, flag_offset=n + 1)
    # the arrival counters a window keeps (every launch leaves them at 0)
    scr = torch.zeros(n + 2, dtype=torch.int32, device=dev)
    blk = rand(a2a_block, torch.bfloat16)
    landed_k, landed_p = torch.zeros_like(blk), torch.zeros_like(blk)
    k46.put_signal_rows(blk, landed_k, tgt_ring, **sig)
    k46.put_signal_rows_plain(blk, landed_p, tgt_ring, **sig)
    check(torch.equal(landed_k, landed_p), "K4 at the dispatch block")
    err = (landed_k.float() - landed_p.float()).abs().max().item()
    rolled_flag = torch.zeros_like(hdr)
    record["put_signal"] = dict(
        ms=graph_ms(torch, lambda: k46.put_signal_rows(
            blk, landed_k, tgt_ring, scratch=scr, **sig)),
        plain_ms=graph_ms(torch, lambda: k46.put_signal_rows_plain(
            blk, landed_p, ring_t, **sig)),
        library_ms=graph_ms(torch, lambda: (
            torch.roll(blk, 1, 0),
            rolled_flag[:, n + 1:n + 2].copy_(torch.roll(bell, 1, 0)))),
        max_abs_err=err, shape=list(a2a_block), dtype="bfloat16")
    nbytes = blk.numel() * 2
    record["put_signal"]["bound_ms"], record["put_signal"]["bound_by"] = \
        bound_ms(2 * nbytes + 8 * n)
    # the same put+signal in the Listing-1 shape: every flag waits for
    # every payload of the launch (the cost P2 removes)
    unordered_ms = graph_ms(torch, lambda: k46.put_signal_rows(
        blk, landed_k, tgt_ring, ordered=False, scratch=scr, **sig))
    print(f"[kernel] put_signal {list(a2a_block)} unordered (Listing 1): "
          f"{unordered_ms:.4f} ms against {record['put_signal']['ms']:.4f} "
          f"ordered", flush=True)
    comb = (n, cp, d_model)
    yb = rand(comb, torch.bfloat16)
    cur = rand(comb, torch.bfloat16)
    out_k, out_p = cur.clone(), cur.clone()
    k46.accumulate_signal_rows(yb, out_k, tgt_ring, op="sum", **sig)
    k46.accumulate_signal_rows_plain(yb, out_p, tgt_ring, op="sum", **sig)
    check(torch.equal(out_k, out_p), "K6 at the combine block")
    err = (out_k.float() - out_p.float()).abs().max().item()
    record["accumulate_signal"] = dict(
        ms=graph_ms(torch, lambda: k46.accumulate_signal_rows(
            yb, out_k, tgt_ring, op="sum", scratch=scr, **sig)),
        plain_ms=graph_ms(torch, lambda: k46.accumulate_signal_rows_plain(
            yb, out_p, ring_t, op="sum", **sig)),
        library_ms=graph_ms(torch, lambda: out_p.index_add_(0, tgt_long,
                                                            yb)),
        max_abs_err=err, shape=list(comb), dtype="bfloat16")
    record["accumulate_signal"]["bound_ms"], \
        record["accumulate_signal"]["bound_by"] = bound_ms(
            3 * yb.numel() * 2 + 8 * n, yb.numel())
    check(not scr.any(), "K4/K6 left their arrival counters set")
    del blk, landed_k, landed_p, yb, cur, out_k, out_p

    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = get_config("qwen3-4b").replace(n_layers=N_LAYERS)
    n_params = sum(p.numel() for p in leaves(
        build_model(cfg).init(0, device="meta")))
    width = -(-n_params // (4 * n)) * (4 * n)      # the train step's layout
    print(f"[plan] qwen3-4b x{N_LAYERS} layers: {n_params} parameters; "
          f"params {n_params * 4 / 2**30:.1f} GiB, ({n}, P) gradient matrix "
          f"{n * width * 4 / 2**30:.1f} GiB, Adam state "
          f"{2 * n_params * 4 / 2**30:.1f} GiB; K5 reduces it in place",
          flush=True)
    x = rand((n, width), torch.float32)
    total = x.sum(0)
    y = x.clone()
    k5.ring_all_reduce(y, axis_size=n, inplace=True)
    k5.ring_all_reduce_plain(x)
    check(torch.equal(x, y), "K5 != its plain ring at the gradient shape")
    err = (y[0] - total).abs().max().item()
    check(torch.allclose(y[0], total, rtol=1e-5, atol=1e-5),
          f"K5 vs the sum oracle: max abs err {err}")
    del x, total
    summed = torch.empty(width, device=dev)

    def ar():
        k5.ring_all_reduce(y, axis_size=n, inplace=True)

    def library_sum():
        torch.sum(y, 0, out=summed)

    def first_after_free(fn) -> float:
        """One call right after the 19.6 GB the check above held is freed
        and the cache emptied: the first K5 calls there read slower than
        the train step's, which frees nothing between steps."""
        torch.cuda.empty_cache()
        junk = torch.empty((n + 1, width), device=dev)
        del junk
        torch.cuda.empty_cache()
        return time_ms(torch, fn, reps=1, warmup=0)

    r5 = record["ring_all_reduce"] = dict(
        first_ms=first_after_free(ar),
        ms=time_ms(torch, ar, reps=5, warmup=3),
        library_first_ms=first_after_free(library_sum),
        library_ms=time_ms(torch, library_sum, reps=5, warmup=3),
        plain_ms=time_ms(torch, lambda: k5.ring_all_reduce_plain(y), reps=1),
        max_abs_err=err, shape=[n, width], dtype="float32",
        design="in place behind the neighbour's ready word, 16-byte vector "
               "loads into registers, tile counters (2048 floats a tile), "
               "last reduce-scatter hop fused with all-gather hop 0, L2 "
               "evict-first hints, every resident block")
    r5["bound_ms"], r5["bound_by"] = bound_ms(2 * n * width * 4,
                                              (n - 1) * width)
    r5["tbps_of_2x"] = 2 * n * width * 4 / r5["ms"] / 1e9
    print(f"[kernel] ring_all_reduce [{n}, {width}]: {r5['ms']:.3f} ms "
          f"warmed ({r5['first_ms']:.3f} the first call after a free), "
          f"{r5['tbps_of_2x']:.2f} TB/s of the 2X bound's bytes; "
          f"torch.sum {r5['library_ms']:.3f} ms warmed "
          f"({r5['library_first_ms']:.3f} first); design: {r5['design']}",
          flush=True)
    del summed
    del y
    torch.cuda.empty_cache()

    # K7 at the JAX kernel test's shapes (f32 and bf16) and the prefill's,
    # each call's variant read from the counter's split
    k7 = sys.modules["repro_torch.kernels.flash_attention"]

    def k7_check(what, q, k, v, **kw):
        before = dict(k7.COUNTER.by_variant)
        got = k7.flash_attention(q, k, v, **kw)
        ran = [n_ for n_, c in k7.COUNTER.by_variant.items()
               if c != before.get(n_, 0)]
        want = k7.flash_attention_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        dt = str(q.dtype).split(".")[1]
        check(ran == [k7.VARIANTS[q.dtype]], f"K7 {what} {dt} ran {ran}")
        check(torch.allclose(got.float(), want.float(), **K7_TOL[dt]),
              f"K7 {what} {dt}: max err {err}")
        print(f"[kernel] flash_attention {what} {dt}: variant {ran[0]}, "
              f"max abs err {err:.3g} (atol {K7_TOL[dt]['atol']})",
              flush=True)
        return err

    for dtype in (torch.float32, torch.bfloat16):
        for b_, h_, s_, hd_, causal, bq, bkv in (
                (2, 4, 256, 64, True, 64, 64), (1, 2, 128, 32, False, 64, 32),
                (1, 1, 512, 128, True, 128, 128),
                (3, 2, 192, 64, True, 64, 64)):
            q, k, v = (rand((b_, h_, s_, hd_), dtype) for _ in range(3))
            k7_check(f"{(b_, h_, s_, hd_)} causal={causal}", q, k, v,
                     causal=causal, block_q=bq, block_kv=bkv)
    cfg_serve = get_config("qwen3-4b")
    H_, KV_, HD_ = cfg_serve.n_heads, cfg_serve.n_kv_heads, cfg_serve.head_dim
    S_ = 1024                        # SERVE_PROMPT rounded up to K7's tile
    q = rand((1, H_, S_, HD_), torch.bfloat16)
    k, v = (rand((1, KV_, S_, HD_), torch.bfloat16) for _ in range(2))
    err = k7_check(f"(1, {H_}, {S_}, {HD_}) causal GQA {H_}/{KV_}", q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    record["flash_attention"] = dict(
        ms=graph_ms(torch, lambda: k7.flash_attention(q, k, v)),
        plain_ms=graph_ms(torch, lambda: k7.flash_attention_plain(q, k, v)),
        library_ms=graph_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                                enable_gqa=True)),
        max_abs_err=err, shape=[1, H_, S_, HD_], dtype="bfloat16",
        variant=k7.VARIANTS[torch.bfloat16])
    pairs = S_ * (S_ + 1) // 2       # causal (query, key) pairs this run needs
    k7_ops = 4 * HD_ * H_ * pairs
    r7 = record["flash_attention"]
    r7["bound_ms"], r7["bound_by"] = bound_ms(
        2 * (q.numel() + k.numel() + v.numel() + q.numel()), k7_ops,
        peak=PEAK_BF16)
    r7["tflops"] = k7_ops / r7["ms"] / 1e9
    r7["vs_library"] = r7["ms"] / r7["library_ms"]
    print(f"[kernel] flash_attention (1, {H_}, {S_}, {HD_}) bfloat16 causal "
          f"GQA {H_}/{KV_}: {r7['variant']} {r7['ms']:.4f} ms, "
          f"{r7['tflops']:.1f} TFLOP/s of causal pairs "
          f"({100 * r7['tflops'] * 1e12 / PEAK_BF16:.1f} % of the bf16 "
          f"peak), {r7['vs_library']:.2f} x scaled_dot_product_attention's "
          f"{r7['library_ms']:.4f} ms in this call", flush=True)
    # the prefill's own call: head-transposed views of (1, 1016, heads, 128)
    # tensors, no pad, the output a view of a (1, 1016, 32, 128) tensor
    qs = rand((1, SERVE_PROMPT, H_, HD_), torch.bfloat16)
    ks, vs = (rand((1, SERVE_PROMPT, KV_, HD_), torch.bfloat16)
              for _ in range(2))
    views = (qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2))
    blk = dict(block_q=SERVE_PROMPT, block_kv=SERVE_PROMPT)
    k7_check(f"views of (1, {SERVE_PROMPT}, {H_}/{KV_}, {HD_})", *views,
             **blk)
    check(k7.flash_attention(*views, **blk).transpose(1, 2).is_contiguous(),
          "K7's prefill output is not a view of (B, S, H, D)")
    r7["prefill_views_ms"] = graph_ms(
        torch, lambda: k7.flash_attention(*views, **blk))
    print(f"[kernel] flash_attention prefill views (1, {SERVE_PROMPT}, "
          f"{H_}/{KV_}, {HD_}): {r7['prefill_views_ms']:.4f} ms", flush=True)
    del q, k, v, qs, ks, vs, views
    # whisper-base's two non-causal calls, as its prefill makes them: the
    # encoder's self-attention over 1500 frames (11 key tiles of 128 and a
    # ragged 92) and the cross-attention of the 128-token prompt over them
    # (sq != sk), on head-transposed views of (B, S, heads, 64) tensors, in
    # float32 and bfloat16; the cross call timed beside SDPA
    cfg_enc = get_config(ENCDEC_ARCH)
    eh, ehd = cfg_enc.n_heads, cfg_enc.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        frames_kv = [rand((ENCDEC_BATCH, ENCDEC_FRAMES, eh, ehd), dtype)
                     for _ in range(3)]
        enc_views = [t.transpose(1, 2) for t in frames_kv]
        k7_check(f"whisper encoder views ({ENCDEC_BATCH}, {ENCDEC_FRAMES}, "
                 f"{eh}, {ehd}) causal=False", *enc_views, causal=False,
                 block_q=ENCDEC_FRAMES, block_kv=ENCDEC_FRAMES)
        cross_q = rand((ENCDEC_BATCH, ENCDEC_PROMPT, eh, ehd),
                       dtype).transpose(1, 2)
        cross_kw = dict(causal=False, block_q=ENCDEC_PROMPT,
                        block_kv=ENCDEC_FRAMES)
        cross_err = k7_check(
            f"whisper cross views q ({ENCDEC_BATCH}, {ENCDEC_PROMPT}, {eh}, "
            f"{ehd}) k/v ({ENCDEC_BATCH}, {ENCDEC_FRAMES}, {eh}, {ehd}) "
            f"causal=False", cross_q, *enc_views[1:], **cross_kw)
    cq_, ck_, cv_ = cross_q, enc_views[1], enc_views[2]
    rc = record["flash_attention_cross"] = dict(
        ms=graph_ms(torch, lambda: k7.flash_attention(cq_, ck_, cv_,
                                                      **cross_kw)),
        plain_ms=graph_ms(torch, lambda: k7.flash_attention_plain(
            cq_, ck_, cv_, **cross_kw)),
        library_ms=graph_ms(torch, lambda: sdpa(cq_, ck_, cv_,
                                                is_causal=False)),
        max_abs_err=cross_err,
        shape=[ENCDEC_BATCH, eh, ENCDEC_PROMPT, ENCDEC_FRAMES, ehd],
        dtype="bfloat16", variant=k7.VARIANTS[torch.bfloat16])
    cross_ops = 4 * ehd * eh * ENCDEC_BATCH * ENCDEC_PROMPT * ENCDEC_FRAMES
    rc["bound_ms"], rc["bound_by"] = bound_ms(
        2 * (2 * cq_.numel() + ck_.numel() + cv_.numel()), cross_ops,
        peak=PEAK_BF16)
    rc["tflops"] = cross_ops / rc["ms"] / 1e9
    rc["vs_library"] = rc["ms"] / rc["library_ms"]
    print(f"[kernel] flash_attention whisper cross bfloat16: {rc['ms']:.4f} "
          f"ms, {rc['tflops']:.1f} TFLOP/s, {rc['vs_library']:.2f} x "
          f"scaled_dot_product_attention's {rc['library_ms']:.4f} ms "
          f"(is_causal=False) in this call", flush=True)
    del frames_kv, enc_views, cross_q, cq_, ck_, cv_

    # K8 and the SSD pass: K8 at the JAX kernel test's shapes in float32 and
    # bfloat16 and at the prefill's (1, 2048, 32 x 64), N 128, chunk 64,
    # bf16; the pass on K8's card outputs against its plain version (the
    # JAX glue) at the same shapes, with and without an initial state; the
    # whole card scan against the sequential oracle in float32
    # (initial state, ragged length) and against the plain scan at the
    # 2040-token prefill in bf16, with its B and C as the model's slices;
    # and one scan traced: exactly two kernels, K8 then the pass
    k8 = sys.modules["repro_torch.kernels.ssd_scan"]
    kp = sys.modules["repro_torch.kernels.ssd_pass"]
    from repro_torch.kernels import ops as ops_mod
    from torch.profiler import ProfilerActivity, profile

    def ssd_inputs(b_, l_, h_, p_, n_, dtype):
        xdt = rand((b_, l_, h_ * p_), torch.float32) * 0.5
        a = -torch.nn.functional.softplus(rand((b_, l_, h_), torch.float32))
        bm, cm = (rand((b_, l_, n_), torch.float32) * 0.5 for _ in range(2))
        return xdt.to(dtype), a, bm.to(dtype), cm.to(dtype)

    def max_err(got, want):
        return max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))

    def k8_check(args, kw, dtype, what):
        got = k8.ssd_intra_chunk(*args, **kw)
        want = k8.ssd_intra_chunk_plain(*args, **kw)
        for name, g, w, tol in zip(
                ("y_intra", "states", "cum"), got, want,
                (K8_TOL[str(dtype).split(".")[1]], K8_TOL["float32"],
                 K8_TOL["float32"])):
            check(g.dtype == w.dtype and g.shape == w.shape
                  and torch.allclose(g.float(), w.float(), **tol),
                  f"K8 {what} {name}: max err "
                  f"{(g.float() - w.float()).abs().max().item()}")
        return max_err(got, want)

    def y_check(got, want, y_intra, what):
        """bf16 y against the plain version's: PASS_BF16_RTOL of |y_intra|
        + |y_inter| (the plain version's values) plus K8's atol."""
        scale = y_intra.float().abs() + (want.float() - y_intra.float()).abs()
        d = (got.float() - want.float()).abs()
        check(bool((d <= K8_TOL["bfloat16"]["atol"]
                    + PASS_BF16_RTOL * scale).all()),
              f"{what}: max err {d.max().item()}")

    def pass_check(args, kw, dtype, what, s0=None):
        """The pass on K8's card outputs against its plain version."""
        y_intra, states, cum = k8.launch_intra_chunk(*args, **kw)
        ins = (y_intra, states, cum, args[3])
        got = kp.ssd_pass(*ins, **kw, initial_state=s0)
        want = kp.ssd_pass_plain(*ins, **kw, initial_state=s0)
        check(all(g.dtype == w.dtype == dtype and g.shape == w.shape
                  for g, w in zip(got, want)), f"the pass {what}: shapes")
        if dtype == torch.float32:
            for g, w in zip(got, want):
                check(torch.allclose(g, w, **K8_TOL["float32"]),
                      f"the pass {what}: max err {(g - w).abs().max().item()}")
        else:
            y_check(got[0], want[0], y_intra.reshape(want[0].shape),
                    f"the pass {what} y")
            check(torch.allclose(got[1].float(), want[1].float(),
                                 **K8_TOL["bfloat16"]),
                  f"the pass {what} final state: max err "
                  f"{max_err(got[1:], want[1:])}")
        return max_err(got, want)

    # the JAX kernel test's shapes, and one whose headdim and d_state are no
    # multiples of 8 (bf16 rows then load one element at a time)
    k8_shapes = ((2, 64, 4, 16, 32, 16), (1, 128, 2, 32, 16, 32),
                 (1, 48, 8, 8, 64, 8), (1, 48, 3, 12, 20, 16))
    pass_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b_, l_, h_, p_, n_, ch in k8_shapes:
            args = ssd_inputs(b_, l_, h_, p_, n_, dtype)
            kw = dict(chunk=ch, nheads=h_, headdim=p_)
            k8_check(args, kw, dtype, (b_, l_, h_, p_, n_, ch, str(dtype)))
            s0 = (rand((b_, h_, p_, n_), torch.float32) * 0.3).to(dtype)
            for init in (None, s0):
                pass_err = max(pass_err, pass_check(
                    args, kw, dtype, (b_, l_, h_, p_, n_, ch, str(dtype)),
                    s0=init))
    # the whole card scan against the sequential oracle, float32: the JAX
    # initial-state case (tests/test_kernels.py:163) and ragged lengths
    for b_, l_, h_, p_, n_, ch, init in ((1, 32, 2, 8, 16, 8, True),
                                         (2, 45, 3, 8, 16, 8, False),
                                         (1, 70, 2, 16, 32, 16, True)):
        xdt, a, bm, cm = ssd_inputs(b_, l_, h_, p_, n_, torch.float32)
        s0 = rand((b_, h_, p_, n_), torch.float32) * 0.3 if init else None
        xdt = xdt.reshape(b_, l_, h_, p_)
        got = ops_mod.ssd_scan(xdt, a, bm, cm, chunk=ch, nheads=h_,
                               headdim=p_, initial_state=s0)
        want = R.ssd_scan_ref(xdt, a, bm, cm, initial_state=s0)
        for g, w in zip(got, want):
            check(torch.allclose(g, w, **K8_TOL["float32"]),
                  f"the card scan {(b_, l_, h_, p_, n_, ch, init)} vs the "
                  f"sequential oracle: max err {(g - w).abs().max().item()}")
    cfg_ssm = get_config(SSM_ARCH)
    ssm_h = cfg_ssm.ssm.expand * cfg_ssm.d_model // cfg_ssm.ssm.headdim
    ssm_p, ssm_n, ssm_q = (cfg_ssm.ssm.headdim, cfg_ssm.ssm.d_state,
                           cfg_ssm.ssm.chunk)
    ssm_l = -(-SSM_PROMPT // ssm_q) * ssm_q     # whole chunks over the prompt
    k8_args = ssd_inputs(1, ssm_l, ssm_h, ssm_p, ssm_n, torch.bfloat16)
    k8_kw = dict(chunk=ssm_q, nheads=ssm_h, headdim=ssm_p)
    err = k8_check(k8_args, k8_kw, torch.bfloat16, "at the prefill shape")
    pass_err = max(pass_err, pass_check(k8_args, k8_kw, torch.bfloat16,
                                        "at the prefill shape"))
    record["ssd_intra_chunk"] = dict(
        ms=graph_ms(torch, lambda: k8.ssd_intra_chunk(*k8_args, **k8_kw)),
        plain_ms=graph_ms(torch, lambda: k8.ssd_intra_chunk_plain(
            *k8_args, **k8_kw)),
        library_ms=None, max_abs_err=err,
        shape=[1, ssm_l, ssm_h * ssm_p, ssm_n], dtype="bfloat16")
    k8_outs = k8.ssd_intra_chunk(*k8_args, **k8_kw)
    pass_ins = k8_outs + (k8_args[3],)
    record["ssd_pass"] = dict(
        ms=graph_ms(torch, lambda: kp.ssd_pass(*pass_ins, **k8_kw)),
        plain_ms=graph_ms(torch, lambda: kp.ssd_pass_plain(
            *pass_ins, **k8_kw)),
        library_ms=None, max_abs_err=pass_err,
        shape=[1, ssm_l, ssm_h * ssm_p, ssm_n], dtype="bfloat16")
    hp_ = ssm_h * ssm_p
    k8_bytes, k8_ops, pass_bytes, pass_ops = ssd_work(ssm_l, ssm_h, ssm_p,
                                                      ssm_n, ssm_q)
    record["ssd_intra_chunk"]["bound_ms"], \
        record["ssd_intra_chunk"]["bound_by"] = bound_ms(
            k8_bytes, k8_ops, peak=PEAK_BF16)
    record["ssd_pass"]["bound_ms"], record["ssd_pass"]["bound_by"] = \
        bound_ms(pass_bytes, pass_ops, peak=PEAK_BF16)
    # the whole scan at the 2040-token prefill, B and C sliced from one
    # projection as the model hands them over, against the plain scan
    xdt, a, bm, cm = (t[:, :SSM_PROMPT] for t in k8_args)
    xbc = torch.cat([bm, cm], -1)
    xdt = xdt.reshape(1, SSM_PROMPT, ssm_h, ssm_p)
    s0 = (rand((1, ssm_h, ssm_p, ssm_n), torch.float32) * 0.3).to(
        torch.bfloat16)
    scan_args = (xdt, a, xbc[..., :ssm_n], xbc[..., ssm_n:])
    got = ops_mod.ssd_scan(*scan_args, **k8_kw, initial_state=s0)
    want = ops_mod.ssd_scan_plain(*scan_args, **k8_kw, initial_state=s0)
    yi_plain = k8.ssd_intra_chunk_plain(
        *(torch.nn.functional.pad(t, (0, 0, 0, ssm_l - SSM_PROMPT))
          for t in (xdt.reshape(1, SSM_PROMPT, hp_), a, bm, cm)),
        **k8_kw)[0][:, :SSM_PROMPT].reshape(want[0].shape)
    y_check(got[0], want[0], yi_plain, "the card scan at the prefill")
    check(torch.allclose(got[1].float(), want[1].float(),
                         **K8_TOL["bfloat16"]),
          f"the card scan's final state at the prefill: max err "
          f"{max_err(got[1:], want[1:])}")
    scan_ms = graph_ms(torch, lambda: ops_mod.ssd_scan(*scan_args, **k8_kw))
    scan_plain_ms = graph_ms(
        torch, lambda: ops_mod.ssd_scan_plain(*scan_args, **k8_kw))
    # one card scan traced, bf16 at the prefill and float32 ragged: two
    # kernels, K8's then the pass's, and nothing else on the card
    f32_args = ssd_inputs(2, 45, 3, 8, 16, torch.float32)
    for what, scan_in, kw in (
            ("bf16 prefill", scan_args, k8_kw),
            ("float32 ragged", (f32_args[0].reshape(2, 45, 3, 8),)
             + f32_args[1:], dict(chunk=8, nheads=3, headdim=8))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops_mod.ssd_scan(*scan_in, **kw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        check(len(names) == 2 and "ssd_intra" in names[0]
              and "ssd_pass" in names[1],
              f"one {what} card scan ran {names}, want K8 then the pass")
    print(f"[kernels] K8 equals its plain version: the JAX kernel test's "
          f"three shapes and (1, 48, 3x12) N 20 chunk 16 in float32 and "
          f"bfloat16, and (1, {ssm_l}, "
          f"{ssm_h}x{ssm_p}) N {ssm_n} chunk {ssm_q} bfloat16 (max abs err "
          f"{err:.3g}); {k8_bytes / 1e6:.2f} MB, {k8_ops / 1e9:.3f} GFLOP",
          flush=True)
    print(f"[kernels] the SSD pass equals its plain version on K8's outputs "
          f"at the same shapes, with and without an initial state (max abs "
          f"err {pass_err:.3g}); {pass_bytes / 1e6:.2f} MB", flush=True)
    print(f"[kernels] the card scan (K8 + pass) equals the sequential oracle "
          f"in float32 (initial state; L 45 and 70, ragged) and the plain "
          f"scan at (1, {SSM_PROMPT}, {ssm_h}x{ssm_p}) bf16 with B and C "
          f"sliced from one projection: {scan_ms:.4f} ms against "
          f"{scan_plain_ms:.4f} plain; one scan traced is two kernels, K8 "
          f"then the pass (bf16 prefill, float32 ragged)", flush=True)
    del k8_args, k8_outs, pass_ins, scan_args, xdt, a, bm, cm, xbc, s0, \
        got, want, yi_plain
    # K8 and the pass at jamba-v0.1-52b's Mamba2 shape: 128 heads x 64,
    # d_state 16 (the card saw only N 128 at full width before), chunk 64,
    # over the [serve-hybrid] prompt of SERVE_PROMPT tokens (a ragged last
    # chunk): K8 and the pass on the whole chunks against their plain
    # versions, then the card scan on the ragged rows, B and C sliced from
    # one projection, against the plain scan; float32 and bfloat16
    cfg_hyb = get_config(HYBRID_ARCH)
    hyb_h = cfg_hyb.ssm.expand * cfg_hyb.d_model // cfg_hyb.ssm.headdim
    hyb_p, hyb_n, hyb_q = (cfg_hyb.ssm.headdim, cfg_hyb.ssm.d_state,
                           cfg_hyb.ssm.chunk)
    hyb_l = -(-SERVE_PROMPT // hyb_q) * hyb_q
    hyb_kw = dict(chunk=hyb_q, nheads=hyb_h, headdim=hyb_p)
    hyb_err = hyb_pass_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        what = f"at jamba's shape N {hyb_n} {str(dtype).split('.')[1]}"
        hyb_args = ssd_inputs(1, hyb_l, hyb_h, hyb_p, hyb_n, dtype)
        hyb_err = max(hyb_err, k8_check(hyb_args, hyb_kw, dtype, what))
        hyb_pass_err = max(hyb_pass_err,
                           pass_check(hyb_args, hyb_kw, dtype, what))
        xdt, a, bm, cm = (t[:, :SERVE_PROMPT] for t in hyb_args)
        xbc = torch.cat([bm, cm], -1)
        xdt = xdt.reshape(1, SERVE_PROMPT, hyb_h, hyb_p)
        scan_args = (xdt, a, xbc[..., :hyb_n], xbc[..., hyb_n:])
        got = ops_mod.ssd_scan(*scan_args, **hyb_kw)
        want = ops_mod.ssd_scan_plain(*scan_args, **hyb_kw)
        if dtype == torch.float32:
            for g, w in zip(got, want):
                check(torch.allclose(g, w, **K8_TOL["float32"]),
                      f"the card scan {what}: max err "
                      f"{(g - w).abs().max().item()}")
        else:
            yi_plain = k8.ssd_intra_chunk_plain(
                *(torch.nn.functional.pad(t, (0, 0, 0, hyb_l - SERVE_PROMPT))
                  for t in (xdt.reshape(1, SERVE_PROMPT, -1), a, bm, cm)),
                **hyb_kw)[0][:, :SERVE_PROMPT].reshape(want[0].shape)
            y_check(got[0], want[0], yi_plain, f"the card scan {what}")
            check(torch.allclose(got[1].float(), want[1].float(),
                                 **K8_TOL["bfloat16"]),
                  f"the card scan's final state {what}: max err "
                  f"{max_err(got[1:], want[1:])}")
    record["ssd_intra_chunk_n16"] = dict(
        ms=graph_ms(torch, lambda: k8.ssd_intra_chunk(*hyb_args, **hyb_kw)),
        plain_ms=graph_ms(torch, lambda: k8.ssd_intra_chunk_plain(
            *hyb_args, **hyb_kw)),
        library_ms=None, max_abs_err=hyb_err,
        shape=[1, hyb_l, hyb_h * hyb_p, hyb_n], dtype="bfloat16")
    hyb_ins = k8.ssd_intra_chunk(*hyb_args, **hyb_kw) + (hyb_args[3],)
    record["ssd_pass_n16"] = dict(
        ms=graph_ms(torch, lambda: kp.ssd_pass(*hyb_ins, **hyb_kw)),
        plain_ms=graph_ms(torch, lambda: kp.ssd_pass_plain(
            *hyb_ins, **hyb_kw)),
        library_ms=None, max_abs_err=hyb_pass_err,
        shape=[1, hyb_l, hyb_h * hyb_p, hyb_n], dtype="bfloat16")
    hk8_bytes, hk8_ops, hpass_bytes, hpass_ops = ssd_work(
        hyb_l, hyb_h, hyb_p, hyb_n, hyb_q)
    for name, nbytes, ops in (("ssd_intra_chunk_n16", hk8_bytes, hk8_ops),
                              ("ssd_pass_n16", hpass_bytes, hpass_ops)):
        record[name]["bound_ms"], record[name]["bound_by"] = bound_ms(
            nbytes, ops, peak=PEAK_BF16)
    print(f"[kernels] K8 and the SSD pass at jamba's Mamba2 shape (1, "
          f"{hyb_l}, {hyb_h}x{hyb_p}) N {hyb_n} chunk {hyb_q} equal their "
          f"plain versions in float32 and bfloat16 (max abs err "
          f"{hyb_err:.3g}, {hyb_pass_err:.3g}), and the card scan the plain "
          f"scan at {SERVE_PROMPT} ragged rows; K8 {hk8_bytes / 1e6:.2f} MB, "
          f"{hk8_ops / 1e9:.3f} GFLOP; the pass {hpass_bytes / 1e6:.2f} MB",
          flush=True)
    del hyb_args, hyb_ins, scan_args, xdt, a, bm, cm, xbc, got, want
    for name, r in record.items():
        lib_ms = r["library_ms"]
        calls = (f", wrapper calls {r['call_ms']:.4f}" if "call_ms" in r
                 else "")
        print(f"[kernel] {name} {r['shape']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}{calls})", flush=True)

    # ---- 2. the paths, every launch counter from 0 just before each -------
    from repro_torch.core.rma import (Window, WindowConfig, all_to_all_plan,
                                      put_signal)
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import layer_plan, stage_plan

    launches = {name: 0 for name in K.COUNTERS}
    #: launches by variant (K3: static / device / guarded; K2 the same;
    #: the wait: programmatic)
    variant_launches: dict[tuple, int] = {}

    def path_counts(what: str, must) -> dict:
        """Read the counters after a path: each of its kernels launched,
        and every launch added to the record."""
        got = K.launch_counts()
        for name in must:
            check(got[name] > 0, f"{what}: kernel {name} never launched")
        for name, c in got.items():
            launches[name] += c
            for v, cv in K.COUNTERS[name].by_variant.items():
                variant_launches[(name, v)] = \
                    variant_launches.get((name, v), 0) + cv
        print(f"[launches] {what}: {got}", flush=True)
        return got

    K.reset_launch_counts()
    buf = torch.zeros((n, M), device=dev)
    win = Window.allocate(buf, "x", n, WindowConfig(
        scope="thread", order=True, max_streams=2))
    sumwin = win.dup_with_info(same_op="sum", max_atomic_elems=ATOMIC_COUNT)
    check(sumwin.substrate is win.substrate, "dup is not zero-copy")
    ring = [(r, (r + 1) % n) for r in range(n)]
    data = rand((n, M), torch.float32)
    win.put(data, ring, stream=0)
    check(win.ledger.by_kind["put"] == 1, "put != 1 phase")
    waits = K.COUNTERS["put_wait"]
    win.flush(stream=1)                  # nothing in flight on stream 1
    check(win.ledger.by_kind["flush"] == 0 and waits.count == 0,
          "idle thread flush paid phases or waited")
    win.flush(stream=0)
    check(win.ledger.by_kind["flush"] == 2, "thread-scope flush != 2 phases")
    check(waits.count == 1, "thread-scope flush != one wait on its counters")
    check(torch.equal(buf, torch.roll(data, 1, 0)), "put landed wrong")
    check(win.substrate.completion_ok(), "put completion counters")
    expect = buf.clone()
    small = rand((n, ATOMIC_COUNT), torch.float32)
    sumwin.accumulate(small, ring, op="sum", offset=0)          # K2
    expect[:, :ATOMIC_COUNT] += torch.roll(small, 1, 0)
    check(win.ledger.by_kind["accumulate"] == 1, "intrinsic != 1 phase")
    sumwin.accumulate(data, ring, op="sum")                      # K3 + K1
    expect += torch.roll(data, 1, 0)
    check(win.ledger.by_kind["accumulate"] == 2, "tiled != 1 phase")
    win.accumulate(small, ring, op="sum", offset=ATOMIC_COUNT)   # software
    expect[:, ATOMIC_COUNT:2 * ATOMIC_COUNT] += torch.roll(small, 1, 0)
    check(win.ledger.by_kind["accumulate"] == 4, "software != 2 phases")
    win.flush(stream=0)
    check(torch.equal(buf, expect), "accumulates landed wrong")
    check(not win.group.pending, "flush left ops in flight")
    check(win.substrate.completion_ok(), "accumulate completion counters")
    print(f"[window] ledger {dict(win.ledger.by_kind)}: put 1, thread flush "
          "2, intrinsic 1, tiled 1, software 2 — the reference cost model",
          flush=True)
    # the quickstart's put_signal (paper Listings 2 and 1): payload then
    # doorbell, one K4 launch, on an ordered and on an unordered window
    signal_phases = {}
    for order, want_phases in ((True, 2), (False, 4)):
        sw = Window.allocate(torch.zeros((n, M), device=dev), "x", n,
                             WindowConfig(scope="thread", order=order,
                                          same_op="sum",
                                          accumulate_ops=("sum",)))
        payload = rand((n, M - 8), torch.float32)
        put_signal(sw, payload, ring, data_offset=0, flag_offset=M - 1)
        signal_phases[order] = sw.ledger.total
        check(sw.ledger.total == want_phases,
              f"put_signal order={order}: {sw.ledger.total} phases, the "
              f"reference cost model bills {want_phases}")
        sw.flush(stream=0)
        check(torch.equal(sw.buffer[:, :M - 8], torch.roll(payload, 1, 0))
              and bool((sw.buffer[:, M - 1] == 1).all()),
              f"put_signal order={order} landed wrong")
        check(sw.substrate.completion_ok(),
              f"put_signal order={order} completion counters")
    print(f"[window] put_signal phases ordered {signal_phases[True]}, "
          f"unordered {signal_phases[False]} (reference: 2 and 4)",
          flush=True)
    path_counts("window tour", ("accumulate", "ring_accumulate", "ring_put",
                                "put_wait", "put_signal"))
    del buf, win, sumwin, data, expect, sw, payload
    torch.cuda.empty_cache()

    # a doorbell never rises over a stalled flush: a pool window puts on
    # lane 1, its flush's K3 wait is held short (owed = ticks + 1 on every
    # rank, so the bounded spin gives up and counts a stall), and a control
    # window's put_signal ordered after the pool's completion token runs
    # K4 with the pool's stall word: the count word lands, the bell stays
    # 0 and the withheld bells count in the control window's stalls.
    # Without the stall the bell rises.  The same calls on the CPU's plain
    # versions give the same words and counts.
    def stall_case(device, payload, stall):
        pool_w = Window.allocate(torch.zeros((n, M), device=device), "x", n,
                                 WindowConfig(scope="thread", order=True,
                                              max_streams=2))
        ctrl_w = Window.allocate(
            torch.zeros((n, 3), dtype=torch.int32, device=device), "x", n,
            WindowConfig(scope="thread", order=True, max_streams=2,
                         same_op="sum", accumulate_ops=("sum",)))
        pool_w.put(payload.to(device), ring, stream=1)
        if stall:
            for owed in pool_w.substrate.expected:
                owed[1] += 1
        pool_w.flush(stream=1)
        put_signal(ctrl_w, torch.full((n, 1), 7, dtype=torch.int32,
                                      device=device), ring, data_offset=0,
                   flag_offset=2, stream=1,
                   after=pool_w.completion_token(1))
        ctrl_w.flush(stream=1)
        landed = torch.equal(pool_w.buffer.cpu(),
                             torch.roll(payload.cpu(), 1, 0))
        return (landed, ctrl_w.buffer.cpu().tolist(),
                int(pool_w.substrate.stalls.item()),
                int(ctrl_w.substrate.stalls.item()))

    K.reset_launch_counts()
    stall_payload = rand((n, M), torch.float32)
    stall_out = {stall: stall_case(dev, stall_payload, stall)
                 for stall in (False, True)}
    stall_counts = path_counts("stalled-flush doorbell",
                               ("ring_put", "put_wait", "put_signal"))
    for stall, want in ((False, (True, [[7, 0, 1]] * n, 0, 0)),
                        (True, (True, [[7, 0, 0]] * n, n, n))):
        check(stall_out[stall] == want,
              f"doorbell after a token, stall={stall}: (landed, control "
              f"words, pool stalls, control stalls) {stall_out[stall]}, "
              f"want {want}")
        check(stall_case("cpu", stall_payload, stall) == want,
              f"the plain versions, stall={stall}: differ from the card's")
    check(stall_counts["put_signal"] == 2 and stall_counts["put_wait"] == 4,
          f"stall check launches {stall_counts}: want 2 K4, 4 waits")
    print(f"[stall] a K3 wait held short (owed = ticks + 1 on {n} ranks) "
          f"counted {n} stalls; K4 after the pool's token then landed its "
          f"count word and withheld all {n} bells (control stalls {n}); "
          f"without the stall every bell rose; the plain versions agree",
          flush=True)
    del stall_payload

    # ---- [p5] memory handles and dynamic windows ------------------------
    # a dynamic window over each rank's 2^24-float pool, slots attached in
    # it; handle windows put, accumulate (intrinsic: K2; tiled: K3, K1, K3)
    # and get through fresh handles and a stale one; the query and AM slow
    # paths; an allocated window at per-rank tensor displacements; a plan's
    # handle ops.  Run once on the card (the path, its counters) and once
    # on the CPU (the plain versions), and held equal bit for bit.
    from repro_torch.core.rma import (DynamicWindow, RmaPlan,
                                      memhandle_create, memhandle_release,
                                      win_from_memhandle)
    seg = P5_POOL // 4                   # slot 0 at [seg, seg + 2^22)
    shift2 = [(r, (r + 2) % n) for r in range(n)]
    p5_cfg = WindowConfig(scope="thread", same_op="sum",
                          max_atomic_elems=ATOMIC_COUNT)
    p5_plan = RmaPlan("p5")
    p5_plan.window("w", scope="thread", same_op="sum",
                   max_atomic_elems=ATOMIC_COUNT, exit_epoch=True)
    p5_plan.bind("x", (ATOMIC_COUNT,), "float32")
    p5_plan.bind("h", (4,), "int32")
    put_h = p5_plan.put_handle("w", "x", "h", ring, slot=0, offset=13)
    p5_plan.output("read", p5_plan.get_handle("w", "h", shift2, offset=13,
                                              size=ATOMIC_COUNT,
                                              after=(put_h,)))
    p5_compiled = p5_plan.compile()
    check(p5_compiled.phases == 6, "plan: handle put 2 + get 2 + exit 2")

    def p5_tour(device, pool, big, small, mid):
        """The P5 path once on ``device``; returns what it produced and the
        windows it ran on."""
        pool = pool.to(device, copy=True)
        big, small, mid = (t.to(device) for t in (big, small, mid))
        # per-rank displacements: one past the pool, one negative through
        # the handle's offset (counts from the end, then clamps)
        disp = torch.tensor([0, 5, P5_POOL, -(seg + 3)], dtype=torch.int32,
                            device=device)
        dyn = DynamicWindow.create_dynamic(pool, "x", n, p5_cfg,
                                           max_attach=4, am_slots=1,
                                           am_msg=M)
        dyn.attach(0, seg, 1 << 22).attach(1, 3 * seg, 1 << 22)
        h0, h1 = memhandle_create(dyn, 0), memhandle_create(dyn, 1)
        mh = win_from_memhandle(dyn, h0, slot=0)
        mh.put(big, ring)                                   # K3 guarded
        mh.accumulate(small, ring, offset=disp)             # K2 guarded
        mh.accumulate(mid, shift2, offset=7)                # K3, K1, K3
        _, got = mh.get(shift2, offset=3, size=1 << 12)     # K3 read
        mh.flush(0)
        memhandle_release(dyn, 1)
        dyn.attach(1, 3 * seg, 1 << 22)                     # h1 is stale
        stale = win_from_memhandle(dyn, h1)
        stale.put(big, ring)                                # dropped
        _, zeros = stale.get(ring, size=64)                 # zeroed
        stale.flush(0)
        dyn.put_query(small, ring, slot=1, seg_offset=11)
        _, queried = dyn.get_query(shift2, slot=1, seg_offset=11,
                                   size=ATOMIC_COUNT)
        dyn.put_am(mid, ring, slot=0, seg_offset=1 << 21)
        dyn.progress()
        dyn.flush_am(ring)
        dyn.flush(0)
        res = p5_compiled.execute({"w": dyn}, {"x": small, "h": h0})
        aw = Window.allocate(torch.zeros((n, 1 << 22), device=device), "x",
                             n, p5_cfg)
        adisp = torch.tensor([0, 1 << 20, (3 << 20) - 5, (1 << 22) - M],
                             dtype=torch.int32, device=device)
        aw.put(big, ring, offset=adisp)                     # K3 device
        aw.accumulate(small, shift2, offset=adisp)          # K2 device
        aw.flush(0)
        out = dict(pool=dyn.buffer, got=got, zeros=zeros, queried=queried,
                   allocated=aw.buffer, errs=mh.err_count,
                   stale_errs=stale.err_count, plan_read=res.outputs["read"],
                   plan_errs=res.err_count)
        ledgers = (dict(dyn.ledger.by_kind), dict(aw.ledger.by_kind))
        return out, ledgers, (dyn, mh, aw, h0)

    p5_in = (rand((n, P5_POOL), torch.float32), rand((n, M), torch.float32),
             rand((n, ATOMIC_COUNT), torch.float32),
             rand((n, 1 << 12), torch.float32))
    K.reset_launch_counts()
    on_card, card_ledgers, (dyn, mh, aw, h0) = p5_tour(dev, *p5_in)
    torch.cuda.synchronize()
    p5_counts = path_counts("p5 tour", ("ring_put", "put_wait",
                                        "ring_accumulate", "accumulate"))
    check(dyn.substrate.completion_ok() and aw.substrate.completion_ok(),
          "[p5] completion counters short or stalled")
    on_cpu, cpu_ledgers, _ = p5_tour(torch.device("cpu"),
                                     *(t.cpu() for t in p5_in))
    for key, want in on_cpu.items():
        check(torch.equal(on_card[key].cpu(), want),
              f"[p5] {key}: the card's tour differs from the plain versions'")
    check(card_ledgers == cpu_ledgers, "[p5] ledgers differ")
    check(on_cpu["errs"].tolist() == [0] * n
          and on_cpu["stale_errs"].tolist() == [2] * n
          and not on_cpu["zeros"].any()
          and on_cpu["plan_errs"].tolist() == [0] * n,
          "[p5] stale-handle counts")
    check(sum(card_ledgers[0].values()) == 38,
          f"[p5] dynamic window ledger {card_ledgers[0]} != 38 phases "
          "(handle put/acc/acc/get 2 each, flushes 2, stale put/get 2 each, "
          "put_query 5, get_query 4, put_am 3, flush_am 2, plan 6)")
    print(f"[p5] tour on the card equals the plain versions bit for bit "
          f"(pool {P5_POOL} float32 x {n}); ledgers {card_ledgers}; stale "
          f"handle counted {on_card['stale_errs'].tolist()}; launches "
          f"{p5_counts}", flush=True)
    del on_cpu, p5_in

    # one K3 launch for a handle put, as for an allocated put
    big = on_card["got"].new_ones((n, M))
    K.reset_launch_counts()
    aw.put(big, ring)
    alloc_k3 = K.COUNTERS["ring_put"].count
    K.reset_launch_counts()
    mh.put(big, ring)
    handle_k3 = K.COUNTERS["ring_put"].count
    check(alloc_k3 == handle_k3 == 1, f"K3 launches: allocated put "
          f"{alloc_k3}, handle put {handle_k3}")
    mh.flush(0)
    aw.flush(0)
    # no host read: every operation below raises if it synchronizes
    small = on_card["got"].new_ones((n, ATOMIC_COUNT))
    mid = on_card["got"].new_ones((n, 1 << 12))
    rank_disp = torch.tensor([0, 3, 5, 9], dtype=torch.int32, device=dev)
    sync_ops = {
        "handle put": lambda: mh.put(big, ring),
        "handle get": lambda: mh.get(shift2, size=1 << 12),
        "handle intrinsic accumulate": lambda: mh.accumulate(small, ring),
        "handle tiled accumulate": lambda: mh.accumulate(mid, ring),
        "thread flush": lambda: mh.flush(0),
        "put_query": lambda: dyn.put_query(small, ring, slot=0),
        "get_query": lambda: dyn.get_query(shift2, slot=0, size=64),
        "put_am and progress": lambda: (dyn.put_am(small, ring, slot=0),
                                        dyn.progress()),
        "put at a per-rank tensor displacement": lambda: aw.put(
            big, ring, offset=rank_disp),
    }
    for op in sync_ops.values():          # build what they cache first
        op()
    aw.flush(0)
    dyn.flush(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for op in sync_ops.values():
            op()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[p5] no host synchronization under set_sync_debug_mode('error'): "
          f"{', '.join(sync_ops)}; K3 launches for a put: allocated "
          f"{alloc_k3}, memory handle {handle_k3}", flush=True)
    aw.flush(0)
    dyn.flush(0)

    def fresh_epoch(sub):
        """Zero the completion counters and what the host says they owe, so
        a captured put + flush waits for its own put on every replay."""
        sub.counters.zero_()
        sub.expected = [[0] * sub.n_streams for _ in range(sub.axis_size)]

    # a handle put and its flush captured in a CUDA graph and replayed
    sent = rand((n, M), torch.float32)

    def handle_put_flush():
        fresh_epoch(dyn.substrate)
        mh.put(sent, ring)
        mh.flush(0)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        handle_put_flush()
    landed = dyn.buffer[:, seg:seg + M]
    landed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(landed, torch.roll(sent, 1, 0)),
          "[p5] the replayed handle put did not land")
    check(dyn.substrate.stalls.item() == 0 and not mh.err_count.any(),
          "[p5] the replayed flush stalled or the handle went stale")
    edges = None
    if "keep_graph" in inspect.signature(torch.cuda.CUDAGraph.__new__
                                         ).parameters:
        kept = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(kept):
            handle_put_flush()
        edges = _build.lib("probes", "rt_graph_programmatic_edges")(
            kept.raw_cuda_graph())
        del kept
    print(f"[p5] a captured handle put + flush replays: landed, 0 stalls; "
          f"programmatic edges kept by capture: "
          f"{'not queryable' if edges is None else edges}", flush=True)

    # paper Fig. 12 on the card: put + thread flush, by graph replay (card
    # time) and by back-to-back calls (host included)
    def per_op(x):
        w = win_from_memhandle(dyn, h0)
        w.put(x, ring)
        w.flush(0)
        w.free()

    fig12 = {}
    for size in P5_SIZES:
        x = big[:, :size].contiguous()
        ways = {
            "allocated": (aw, lambda x=x: (aw.put(x, ring), aw.flush(0))),
            "memhandle": (dyn, lambda x=x: (mh.put(x, ring), mh.flush(0))),
            "memhandle per op": (dyn, lambda x=x: per_op(x)),
            "dynamic query": (dyn, lambda x=x: (
                dyn.put_query(x, ring, slot=0), dyn.flush(0))),
            "dynamic AM": (dyn, lambda x=x: (
                dyn.put_am(x, ring, slot=0), dyn.progress(),
                dyn.flush_am(ring))),
        }
        fns = {}
        for way, (w, op) in ways.items():
            def fn(w=w, op=op):
                fresh_epoch(w.substrate)
                op()
            fns[way] = fn
        # by calls the host's noise dominates: three rounds over the ways
        # in turn, the median of each way's three means
        calls = {way: [] for way in fns}
        for _ in range(3):
            for way, fn in fns.items():
                calls[way].append(time_ms(torch, fn, reps=20))
        fig12[size] = {way: (graph_ms(torch, fn, reps=10),
                             sorted(calls[way])[1])
                       for way, fn in fns.items()}
    check(dyn.substrate.stalls.item() == 0 and aw.substrate.stalls.item() == 0,
          "[p5] a timed flush stalled")
    for size, row in fig12.items():
        base = row["allocated"]
        print(f"[p5] Fig. 12, put + thread flush of {size} floats, ms by "
              f"graph replay / by calls: " + "; ".join(
                  f"{way} {g:.4f} / {c:.4f} ({g / base[0]:.2f} x / "
                  f"{c / base[1]:.2f} x)" for way, (g, c) in row.items()),
              flush=True)
    # what a handle op's wrapper checks on the host beyond an allocated
    # op's: its handle, registration and count tensors, every call
    t0 = time.perf_counter()
    for _ in range(2000):
        k3._check_address(n, h0.device, None, None, None, None)
    t1 = time.perf_counter()
    for _ in range(2000):
        k3._check_address(n, h0.device, None, h0, dyn.regs, mh.err_count)
    t2 = time.perf_counter()
    print(f"[p5] host us per wrapper call checking the device address: none "
          f"{(t1 - t0) / 2e-3:.2f}, handles + registrations + counts "
          f"{(t2 - t1) / 2e-3:.2f}", flush=True)
    record["put_wait"]["fig12_ms"] = {
        str(size): {way: list(v) for way, v in row.items()}
        for size, row in fig12.items()}
    del dyn, mh, aw, h0, on_card, big, small, mid, landed, graph, sent
    torch.cuda.empty_cache()

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = train("qwen3-4b", tiny=False, n_layers=N_LAYERS, steps=STEPS,
                global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, peak_lr=1e-3,
                warmup_steps=0, grad_sync="rma_ring", dp_ranks=n,
                device="cuda", log_every=1)
    counts = path_counts("qwen3-4b step", ("ring_all_reduce", "put_wait"))
    cfg_dense_remat = get_config("qwen3-4b").remat
    check(cfg_dense_remat == "block", "qwen3-4b: remat is not the default")
    check(run.n_params == n_params, "parameter count")
    check(all(v == v and abs(v) < 1e6 for v in run.losses), "loss not finite")
    check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    check(counts["ring_all_reduce"] == STEPS, "K5 did not run once per step")
    check(run.phases == 2 * n, "ring + exit epoch != 2n phases")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(len(run.part_ms) == STEPS, "the step's parts were not timed")
    parts = {k: [round(p[k], 2) for p in run.part_ms]
             for k in run.part_ms[0]}
    print(f"[train] qwen3-4b d2560 x{N_LAYERS} layers, {n} ranks, batch "
          f"{GLOBAL_BATCH}x{SEQ_LEN} bf16, remat={cfg_dense_remat}: losses "
          f"{[round(v, 4) for v in run.losses]}; step ms "
          f"{[round(v, 1) for v in run.step_ms]}; parts ms (CUDA events) "
          f"{parts}; peak memory {peak_gib:.1f} GiB ({smi})", flush=True)
    ring_run = dict(losses=run.losses, step_ms=run.step_ms, peak=peak_gib)
    del run
    torch.cuda.empty_cache()

    # ---- [dryrun-card] the dry-run of [train]'s configuration on the card --
    dryrun_card(torch, dev, smi, n, K, get_config, path_counts)

    # ---- [backends] the plan backends at the [train] shapes ----------------
    from repro_torch.core.rma import RmaPlan, plan_all_to_all
    from repro_torch.core.rma import plan as plan_mod
    from repro_torch.core.rma.backends import costmodel
    from repro_torch.core.rma.collectives import (all_reduce_plan,
                                                  plan_all_reduce,
                                                  ring_all_gather,
                                                  ring_reduce_scatter,
                                                  rma_all_reduce)

    table_dir = tempfile.mkdtemp(prefix="chip_smoke_backends_")
    matrix_rows: list[dict] = []
    matrix_us: dict[str, dict[str, float]] = {}

    def matrix_row(pattern, backend, ms, shape, dtype, **extra):
        matrix_rows.append({"name": f"backend_matrix/{pattern}/{backend}",
                            "us_per_call": ms * 1e3, "shape": list(shape),
                            "dtype": dtype, **extra})
        matrix_us.setdefault(pattern, {})[backend] = ms * 1e3

    def write_table(name):
        """The measured rows in the format ``costmodel`` reads, in a
        temporary directory; the variable that points ``auto`` at it is set
        to the new file.  Returns ``{pattern: (target, reason)}``."""
        path = os.path.join(table_dir, name)
        doc = {"section": "backends", "card": smi, "rows": matrix_rows}
        with open(path, "w") as f:
            json.dump(doc, f)
        picks = {pat: costmodel.choose(pat, path) for pat in matrix_us}
        doc["auto_pick"] = {pat: {"target": t, "reason": r}
                            for pat, (t, r) in picks.items()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        os.environ["RMA_TORCH_BACKEND_BENCH_JSON"] = path
        for pat, (target, reason) in picks.items():
            lat = {b: matrix_us[pat][b] for b in costmodel.AUTO_CANDIDATES}
            check(lat[target] == min(lat.values()) and
                  reason.startswith("measured"),
                  f"[backends] auto picks {target} for {pat} from {lat}")
        return picks

    # the ring macro at the gradient's shape, integer-valued: every backend
    # bit for bit first, then timed as the train step replays it (in place)
    gwidth = -(-n_params // (4 * n)) * (4 * n)
    xg = torch.empty((n, gwidth), device=dev).random_(-8, 8, generator=gen)
    K.reset_launch_counts()
    k5_sum = plan_all_reduce(xg.clone(), "x", n, backend="rma",
                             donate=True)[0].clone()
    check(K.launch_counts()["ring_all_reduce"] == 1, "[backends] rma: K5")
    g_sum = plan_all_reduce(xg, "x", n, backend="gspmd")
    check(K.launch_counts()["ring_all_reduce"] == 1,
          "[backends] gspmd launched K5")
    check(g_sum.stride(0) == 0 and torch.equal(g_sum[0], k5_sum),
          "[backends] ring: gspmd differs from rma (or is not one row)")
    del g_sum
    xs = xg[:, :INTERPRET_ELEMS].contiguous()
    i_sum = plan_all_reduce(xs, "x", n, backend="interpret")
    check(torch.equal(i_sum, plan_all_reduce(xs.clone(), "x", n,
                                             backend="rma", donate=True)),
          "[backends] ring: the walker differs from rma")
    del i_sum
    xt = xg.clone()
    for backend in ("rma", "gspmd"):
        ms = time_ms(torch, lambda b=backend: plan_all_reduce(
            xt, "x", n, backend=b, donate=True), reps=5, warmup=2)
        matrix_row("ring", backend, ms, (n, gwidth), "float32")
    del xt
    matrix_row("ring", "interpret", time_ms(torch, lambda: plan_all_reduce(
        xs, "x", n, backend="interpret"), reps=2, warmup=1),
        (n, INTERPRET_ELEMS), "float32")
    path_counts("backend matrix, ring", ("ring_all_reduce",))
    picks = write_table("ring.json")
    ring_pick = picks["ring"][0]
    check(all_reduce_plan("x", n, (gwidth,), torch.float32,
                          backend="auto").backend == ring_pick,
          "[backends] all_reduce_plan(auto) ignores the table")
    print(f"[backends] ring macro ({n}, {gwidth}) float32, integer-valued: "
          f"rma = gspmd = the walker's ({n}, {INTERPRET_ELEMS}) bit for bit; "
          f"us per call (CUDA events) "
          f"{ {b: round(v, 1) for b, v in matrix_us['ring'].items()} }; "
          f"auto picks {ring_pick}: {picks['ring'][1]} ({smi})", flush=True)

    # the imperative rings at the gradient's shape, on a lent window: every
    # composition equals K5's sum bit for bit, each ledger the cost model
    lent = Window.allocate(torch.zeros((n, 1), device=dev), "x", n,
                           WindowConfig(scope="thread", max_streams=2))
    rings = []
    for order in (True, False):
        for bidi in (False, True):
            dirs = 2 if bidi else 1
            K.reset_launch_counts()
            before = lent.ledger.total
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t2 = torch.cuda.Event(enable_timing=True)
            t0.record()
            mine = ring_reduce_scatter(xg, "x", n, order=order,
                                       bidirectional=bidi, win=lent)
            t1.record()
            if bidi:    # the low half rode shift +1, the high half -1
                c = mine.shape[1] // 2
                full = torch.cat([
                    ring_all_gather(mine[:, :c], "x", n, order=order,
                                    owner_shift=1, win=lent),
                    ring_all_gather(mine[:, c:], "x", n, order=order,
                                    owner_shift=n - 1, win=lent)], dim=1)
            else:
                full = ring_all_gather(mine, "x", n, order=order,
                                       owner_shift=1, win=lent)
            t2.record()
            torch.cuda.synchronize()
            del mine
            check(torch.equal(full, k5_sum.expand(n, -1)),
                  f"[backends] rings order={order} bidi={bidi} != K5's sum")
            del full
            counts = path_counts(f"imperative rings order={order} "
                                 f"bidirectional={bidi}",
                                 ("ring_put", "put_wait"))
            flushes = 0 if order else (n - 2)
            rs_ph = dirs * ((n - 1) + 2 * flushes + 2)
            ag_ph = dirs * ((n - 1) + 2 * flushes + 2)
            got_ph = lent.ledger.total - before
            check(got_ph == rs_ph + ag_ph,
                  f"[backends] rings order={order} bidi={bidi}: ledger "
                  f"{got_ph}, cost model {rs_ph} + {ag_ph}")
            check(counts["ring_put"] == 2 * dirs * (n - 1) and
                  counts["put_wait"] == 2 * dirs * (flushes + 1),
                  f"[backends] rings order={order} bidi={bidi}: {counts}")
            rings.append((order, bidi, t0.elapsed_time(t1),
                          t1.elapsed_time(t2), counts["ring_put"],
                          counts["put_wait"], got_ph))
    plan_mod._LEGACY_WARNED.discard("repro_torch.core.rma.rma_all_reduce")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            red = rma_all_reduce(xg, "x", n)
            check(torch.equal(red, k5_sum.expand(n, -1)),
                  "[backends] rma_all_reduce != plan_all_reduce's sum")
            del red
    deprecations = [w for w in caught
                    if issubclass(w.category, DeprecationWarning)]
    check(len(deprecations) == 1, f"rma_all_reduce warned {len(caught)}")
    k5_ms = matrix_us["ring"]["rma"] / 1e3
    for order, bidi, rs_ms, ag_ms, k3_n, waits, ph in rings:
        print(f"[backends] ring_reduce_scatter order={order} "
              f"bidirectional={bidi} + ring_all_gather(owner_shift=1): "
              f"{rs_ms:.2f} + {ag_ms:.2f} ms (CUDA events; K5 "
              f"{k5_ms:.2f} ms), K3 {k3_n}, waits {waits}, ledger {ph} = the "
              f"cost model; equal to K5's sum bit for bit", flush=True)
    print("[backends] rma_all_reduce warned once and equals "
          "plan_all_reduce (K5) bit for bit", flush=True)
    del xg, xs, k5_sum, lent
    torch.cuda.empty_cache()

    # the qwen3-4b step on each backend, from the [train] run's seeds
    for backend in ("gspmd", "auto"):
        target = ring_pick if backend == "auto" else backend
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run = train("qwen3-4b", tiny=False, n_layers=N_LAYERS,
                    steps=STEPS, global_batch=GLOBAL_BATCH,
                    seq_len=SEQ_LEN, peak_lr=1e-3, warmup_steps=0,
                    grad_sync="rma_ring", dp_ranks=n, backend=backend,
                    device="cuda", log_every=STEPS)
        counts = path_counts(f"qwen3-4b step, backend={backend}", ())
        want_k5 = STEPS if target == "rma" else 0
        check(counts["ring_all_reduce"] == want_k5,
              f"backend={backend}: K5 {counts['ring_all_reduce']}, want "
              f"{want_k5}")
        check(run.phases == (2 * n if target == "rma" else 0),
              f"backend={backend}: ring phases {run.phases}")
        want = ring_run["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(run.losses, want))
        check(run.losses[0] == want[0] and gap <= BACKEND_LOSS_RTOL,
              f"backend={backend}: losses {run.losses} vs rma {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        sync = [round(p["sync"], 2) for p in run.part_ms]
        print(f"[backends] qwen3-4b x{N_LAYERS} backend={backend} "
              f"({target}): losses {[round(v, 4) for v in run.losses]}, "
              f"max relative gap to rma {gap:.3g} (bound "
              f"{BACKEND_LOSS_RTOL}); step ms "
              f"{[round(v, 1) for v in run.step_ms]} (rma "
              f"{[round(v, 1) for v in ring_run['step_ms']]}"
              f"); sync ms {sync}; K5 {counts['ring_all_reduce']}, ring "
              f"phases {run.phases}; peak {peak:.1f} GiB (rma "
              f"{ring_run['peak']:.1f}) ({smi})", flush=True)
        del run
        torch.cuda.empty_cache()

    # the planned all-to-all at the MoE exchange's shape: the kernels' run
    # is held bit for bit to the same plan run op by op (K3 transfers, K2
    # doorbells), and its ledger to the JAX planner's count
    a2a_shape = (n * cp, d_model + 1)
    send_counts = torch.randint(0, cp + 1, (n, n), generator=gen, device=dev,
                                dtype=torch.int32)

    def a2a_windows(x, op):
        hdr_w = Window.allocate(
            torch.zeros((n, 2 * n), dtype=torch.int32, device=dev), "x", n,
            WindowConfig(scope="thread", order=True, max_streams=2,
                         same_op="sum", accumulate_ops=("sum",)))
        acc = {} if op is None else {"same_op": op, "accumulate_ops": (op,)}
        data_w = Window.allocate(x.clone(), "x", n, WindowConfig(
            scope="thread", order=True, max_streams=2, **acc))
        return {"data": data_w, "hdr": hdr_w}

    a2a_cases = []
    for dtype in (torch.int32, torch.bfloat16):
        x = rand((n,) + a2a_shape, dtype)
        for op in (None, "sum"):
            compiled = all_to_all_plan("x", n, a2a_shape, dtype, op=op)
            kinds = {low[1] for low in compiled.lowering}
            check(kinds == {"k4" if op is None else "k6"},
                  f"a2a op={op}: lowering {compiled.lowering}")
            opbyop = dataclasses.replace(compiled, signal_pairs=())
            want = opbyop.execute(a2a_windows(x, op),
                                  {"x": x, "counts": send_counts}).outputs
            a2a_cases.append((x, op, compiled, want))
    K.reset_launch_counts()
    for x, op, compiled, want in a2a_cases:
        wins = a2a_windows(x, op)
        got = compiled.execute(wins, {"x": x, "counts": send_counts}).outputs
        for name in ("out", "counts", "bells"):
            check(torch.equal(got[name], want[name]),
                  f"a2a {x.dtype} op={op}: {name} differs from op by op")
        ledger = sum(w.ledger.total for w in wins.values())
        check(ledger == compiled.phases == A2A_PHASES,
              f"a2a {x.dtype} op={op}: ledger {ledger}, planned "
              f"{compiled.phases}, JAX planner {A2A_PHASES}")
    counts = path_counts("all-to-all", ("put_signal", "accumulate_signal"))
    check(counts["put_signal"] == counts["accumulate_signal"] == 2 * (n - 1),
          f"a2a launches {counts}: want one K4 (plain) or K6 (sum) per peer "
          f"and exchange")
    print(f"[a2a] n={n} blocks ({cp}, {d_model + 1}) int32 and bfloat16, "
          f"op None/sum: bit-identical to op by op; ledger {A2A_PHASES} "
          f"phases = the JAX planner's; K4 {counts['put_signal']}, K6 "
          f"{counts['accumulate_signal']} launches", flush=True)
    del a2a_cases, x, want, got, wins
    torch.cuda.empty_cache()

    # [backends] the a2a macro at the same blocks: dispatch (op=None) and
    # combine (op="sum") on every backend, bit for bit, then timed; auto's
    # table gets the mean of the two
    xa = torch.empty((n,) + a2a_shape, device=dev,
                     dtype=torch.bfloat16).random_(-8, 8, generator=gen)
    K.reset_launch_counts()
    a2a_ms: dict[str, list] = {}
    for op in (None, "sum"):
        res = {b: plan_all_to_all(xa, "x", n, counts=send_counts, op=op,
                                  backend=b)
               for b in ("rma", "gspmd", "interpret")}
        for b in ("gspmd", "interpret"):
            check(all(torch.equal(u, v) for u, v in zip(res[b], res["rma"])),
                  f"[backends] a2a op={op}: {b} differs from rma")
        del res
        for b in ("rma", "gspmd", "interpret"):
            a2a_ms.setdefault(b, []).append(time_ms(
                torch, lambda b=b, op=op: plan_all_to_all(
                    xa, "x", n, counts=send_counts, op=op, backend=b),
                reps=10, warmup=2))
    path_counts("backend matrix, a2a", ("put_signal", "accumulate_signal"))
    for b, (ms_plain, ms_sum) in a2a_ms.items():
        matrix_row("a2a", b, (ms_plain + ms_sum) / 2, (n,) + a2a_shape,
                   "bfloat16", dispatch_ms=ms_plain, combine_ms=ms_sum)
    picks = write_table("backends.json")
    a2a_pick = picks["a2a"][0]
    check(all_to_all_plan("x", n, a2a_shape, torch.bfloat16,
                          backend="auto").backend == a2a_pick,
          "[backends] all_to_all_plan(auto) ignores the table")
    # one plan holding both macros: compile(backend="auto") records each
    # pick and the measurement behind it
    probe = RmaPlan("auto-probe")
    probe.window("ring", order=True, same_op="sum")
    probe.window("data", order=True, max_streams=2)
    probe.window("hdr", order=True, max_streams=2, same_op="sum",
                 dtype=torch.int32)
    probe.bind("g", (4 * n,), torch.float32)
    probe.bind("x", (2 * n, 3), torch.float32)
    probe.bind("counts", (n,), torch.int32)
    probe.output("sum", probe.ring_all_reduce(
        "ring", "g", "x", n, shape=(4 * n,), dtype=torch.float32))
    for name, ref in zip(("out", "counts", "bells"), probe.all_to_all(
            "data", "hdr", "x", "counts", "x", n, shape=(2 * n, 3),
            dtype=torch.float32)):
        probe.output(name, ref)
    chosen = probe.compile(backend="auto")
    check([low[:2] for low in chosen.lowering[:2]] ==
          [("ring[ring]", ring_pick), ("a2a[data]", a2a_pick)] and all(
              low[2] == picks[pat][1] for low, pat in
              zip(chosen.lowering, ("ring", "a2a"))),
          f"[backends] compile(auto) lowering {chosen.lowering}")
    print(f"[backends] a2a macro ({n}, {a2a_shape[0]}, {a2a_shape[1]}) "
          f"bfloat16, integer-valued, op None and sum: rma = gspmd = the "
          f"walker bit for bit; ms per call (dispatch, combine; CUDA events) "
          f"{ {b: [round(v, 4) for v in ms] for b, ms in a2a_ms.items()} }; "
          f"auto picks {a2a_pick}: {picks['a2a'][1]}; compile(auto) "
          f"lowering {chosen.lowering[:2]} ({smi})", flush=True)
    del xa
    torch.cuda.empty_cache()

    # the expert-parallel train step at full width
    moe_cfg = cfg_moe.replace(n_layers=N_LAYERS, moe=dataclasses.replace(
        cfg_moe.moe, num_experts=MOE_EXPERTS))
    moe_params = sum(p.numel() for p in leaves(
        build_model(moe_cfg).init(0, device="meta")))
    print(f"[plan] {MOE_ARCH} x{N_LAYERS} layers, {MOE_EXPERTS} experts over "
          f"{EP_RANKS} ranks: {moe_params} parameters, "
          f"{moe_params * 16 / 2**30:.1f} GiB of weights, gradients and Adam "
          f"state", flush=True)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = train(MOE_ARCH, tiny=False, n_layers=N_LAYERS,
                num_experts=MOE_EXPERTS, steps=MOE_STEPS,
                global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, peak_lr=1e-3,
                warmup_steps=0, grad_sync="gspmd", moe_ep="rma",
                ep_ranks=EP_RANKS, device="cuda", log_every=1)
    counts = path_counts(f"{MOE_ARCH} step", ("put_signal",
                                              "accumulate_signal"))
    check(run.n_params == moe_params, "MoE parameter count")
    check(all(v == v and abs(v) < 1e6 for v in run.losses), "loss not finite")
    check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    # per MoE layer and step: dispatch (K4) and combine (K6) forward, and
    # each one's transpose in the backward, n-1 peers each; under
    # remat="block" a MoE layer inside a scanned period runs its forward
    # exchanges once more in the recompute (at x2 the plan is prefix 0,
    # period 2: the MoE layer is inside, so 3(n-1) = 9 each a step)
    moe_plan = layer_plan(moe_cfg)
    moe_prefix, _ = stage_plan(moe_plan)
    n_moe = sum(sp.ffn == "moe" for sp in moe_plan)
    n_moe_remat = (sum(sp.ffn == "moe" for sp in moe_plan[moe_prefix:])
                   if moe_cfg.remat == "block" else 0)
    per_step = (2 * n_moe + n_moe_remat) * (EP_RANKS - 1)
    check(moe_cfg.remat == "block" and (n_moe, n_moe_remat, per_step)
          == (1, 1, 3 * (EP_RANKS - 1)),
          f"{MOE_ARCH} x{N_LAYERS}: remat {moe_cfg.remat}, {n_moe} MoE "
          f"layers, {n_moe_remat} rematerialized, {per_step} K4/K6 a step")
    check(counts["put_signal"] == counts["accumulate_signal"]
          == per_step * MOE_STEPS,
          f"K4/K6 launches {counts['put_signal']}/"
          f"{counts['accumulate_signal']}, want {per_step} each per step")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(len(run.part_ms) == MOE_STEPS, "the step's parts were not timed")
    parts = {k: [round(p[k], 2) for p in run.part_ms]
             for k in run.part_ms[0]}
    print(f"[train] {MOE_ARCH} d{d_model} x{N_LAYERS} layers (dense, MoE), "
          f"{MOE_EXPERTS} experts top-{cfg_moe.moe.top_k} over {EP_RANKS} "
          f"ranks, batch {GLOBAL_BATCH}x{SEQ_LEN} bf16: losses "
          f"{[round(v, 4) for v in run.losses]}; step ms "
          f"{[round(v, 1) for v in run.step_ms]}; parts ms (CUDA events; "
          f"exchanges lie inside grads) {parts}; peak memory "
          f"{peak_gib:.1f} GiB; remat={moe_cfg.remat}: K4 and K6 {per_step} "
          f"each a step (2 x {n_moe} MoE layer + {n_moe_remat} recomputed, "
          f"x {EP_RANKS - 1} peers) ({smi})", flush=True)
    moe_run = dict(losses=run.losses, step_ms=run.step_ms,
                   exchanges=[p["exchanges"] for p in run.part_ms])
    del run
    torch.cuda.empty_cache()

    # [backends] the expert-parallel step with its exchanges on each backend
    for ep_backend in ("gspmd", "auto"):
        target = a2a_pick if ep_backend == "auto" else ep_backend
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run = train(MOE_ARCH, tiny=False, n_layers=N_LAYERS,
                    num_experts=MOE_EXPERTS, steps=MOE_STEPS,
                    global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                    peak_lr=1e-3, warmup_steps=0, grad_sync="gspmd",
                    moe_ep="rma", ep_ranks=EP_RANKS, ep_backend=ep_backend,
                    device="cuda", log_every=MOE_STEPS)
        counts = path_counts(f"{MOE_ARCH} step, ep_backend={ep_backend}",
                             ())
        per = per_step * MOE_STEPS if target == "rma" else 0
        check(counts["put_signal"] == counts["accumulate_signal"] == per
              and (counts["ring_put"] > 0) == (target == "rma")
              and (counts["put_wait"] > 0) == (target == "rma"),
              f"ep_backend={ep_backend}: launches {counts}")
        want = moe_run["losses"]
        check(run.losses == want,
              f"ep_backend={ep_backend}: losses {run.losses} != rma's {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        exch = [round(p["exchanges"], 2) for p in run.part_ms]
        print(f"[backends] {MOE_ARCH} x{N_LAYERS} ep_backend={ep_backend} "
              f"({target}): losses equal rma's bit for bit "
              f"{[round(v, 4) for v in run.losses]}; step ms "
              f"{[round(v, 1) for v in run.step_ms]} (rma "
              f"{[round(v, 1) for v in moe_run['step_ms']]}"
              f"); exchanges ms {exch} (rma "
              f"{[round(v, 2) for v in moe_run['exchanges']]}"
              f"); K4 {counts['put_signal']}, K6 "
              f"{counts['accumulate_signal']}, K3 {counts['ring_put']}, "
              f"waits {counts['put_wait']}; peak {peak:.1f} GiB ({smi})",
              flush=True)
        del run
        torch.cuda.empty_cache()
    del os.environ["RMA_TORCH_BACKEND_BENCH_JSON"]
    shutil.rmtree(table_dir)

    # the serving path: qwen3-4b at all 36 layers, one request set through a
    # dense engine and a paged engine with copy-on-write prefix sharing
    import numpy as np

    from repro_torch.serve.engine import Request, ServeEngine

    attn_mod = sys.modules["repro_torch.models.attention"]
    serve_model = build_model(cfg_serve)
    t0 = time.perf_counter()
    serve_params = serve_model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_serve = sum(p.numel() for p in leaves(serve_params))
    print(f"[plan] {cfg_serve.name} x{cfg_serve.n_layers} layers d"
          f"{cfg_serve.d_model}: {n_serve} float32 parameters "
          f"({n_serve * 4 / 2**30:.1f} GiB) initialized on the card from seed "
          f"0 in {time.perf_counter() - t0:.1f} s", flush=True)
    prng = np.random.RandomState(0)
    prefix = prng.randint(0, cfg_serve.vocab, size=SERVE_PREFIX)
    prompts = [np.concatenate([prefix, prng.randint(
        0, cfg_serve.vocab, size=SERVE_PROMPT - SERVE_PREFIX)])
        for _ in range(3)]
    prompts.append(prompts[2].copy())
    prompts += [prng.randint(0, cfg_serve.vocab, size=SERVE_PROMPT)
                for _ in range(SERVE_REQUESTS - len(prompts))]
    serve_out = {}
    for mode, kw in (("dense", {}),
                     ("paged+cow", dict(paged_kv=True, page_tokens=SERVE_PAGE,
                                        prefix_share=True))):
        eng = ServeEngine(serve_model, serve_params, n_slots=SERVE_SLOTS,
                          max_seq=SERVE_MAX_SEQ, **kw)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid, prompt, SERVE_NEW))
        spent = {"prefill": [], "decode": []}
        for part in spent:            # both calls end in a host read
            def timed(*a, _fn=getattr(eng.executor, part), _t=spent[part]):
                t = time.perf_counter()
                out = _fn(*a)
                _t.append((time.perf_counter() - t) * 1e3)
                return out
            setattr(eng.executor, part, timed)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run(strict=True)
        wall = time.perf_counter() - t0
        counts = path_counts(f"serve {mode}", ("flash_attention",))
        n_prefill = len(spent["prefill"])
        check(n_prefill == SERVE_REQUESTS, f"{mode}: {n_prefill} prefills")
        check(counts["flash_attention"] == cfg_serve.n_layers * n_prefill,
              f"{mode}: K7 launched {counts['flash_attention']} times, want "
              f"{cfg_serve.n_layers} x {n_prefill} prefills")
        check(k7.COUNTER.by_variant == {
            k7.VARIANTS[torch.bfloat16]: counts["flash_attention"]},
              f"{mode}: K7 variants {k7.COUNTER.by_variant}, want only the "
              f"bfloat16 one")
        tokens = {c.rid: c.tokens for c in done}
        check(sorted(tokens) == list(range(SERVE_REQUESTS)) and all(
            len(t) == SERVE_NEW and all(0 <= x < cfg_serve.vocab for x in t)
            for t in tokens.values()), f"{mode}: tokens {tokens}")
        st = eng.stats()
        if eng.paged_kv:
            eng.pool.check_conservation()
            check(st["cow_copies"] > 0 and st["pages_shared"] > 0,
                  f"{mode}: no page was shared or forked: {st}")
            check(eng.pool.n_free == eng.pool.n_pages,
                  f"{mode}: pages still held after the run: {st}")
        n_tok = sum(len(t) for t in tokens.values())
        serve_out[mode] = tokens
        pre, dec = spent["prefill"], spent["decode"]
        print(f"[serve] {mode}: {SERVE_REQUESTS} requests x {SERVE_PROMPT} "
              f"prompt tokens, {SERVE_NEW} new each, {SERVE_SLOTS} slots, "
              f"max_seq {SERVE_MAX_SEQ}, bf16: {n_tok} tokens in {wall:.2f} s "
              f"({n_tok / wall:.1f} tok/s); prefill ms per request "
              f"{[round(x, 1) for x in pre]}; decode ms per tick median "
              f"{sorted(dec)[len(dec) // 2]:.2f} (min {min(dec):.2f}, max "
              f"{max(dec):.2f}, {len(dec)} ticks); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; stats "
              f"{st}", flush=True)
        del eng
    check(serve_out["dense"] == serve_out["paged+cow"],
          "dense and paged+COW greedy tokens differ")
    print("[serve] dense and paged+COW greedy tokens equal bit for bit",
          flush=True)
    # one prefill on K7 against the same prefill on K7's plain version
    tok = torch.as_tensor(prompts[0], dtype=torch.int64, device=dev)[None]
    logits = {}
    for name, fn in (("K7", attn_mod.flash_attention),
                     ("plain", k7.flash_attention_plain)):
        attn_mod.flash_attention = fn
        try:
            logits[name], _ = serve_model.prefill(
                serve_params, {"tokens": tok},
                serve_model.init_cache(1, SERVE_MAX_SEQ))
        finally:
            attn_mod.flash_attention = k7.flash_attention
    lanes = slice(0, cfg_serve.vocab)     # the padded lanes hold -1e30
    diff = (logits["K7"][..., lanes] - logits["plain"][..., lanes]
            ).abs().max().item()
    scale = logits["plain"][..., lanes].abs().max().item()
    check(bool(torch.isfinite(logits["K7"]).all()), "prefill logits finite")
    check(diff <= PREFILL_LOGIT_RTOL * scale,
          f"prefill logits on K7 vs its plain version: max |d| {diff} of max "
          f"|logit| {scale}")
    print(f"[serve] one prefill's last logits, K7 vs its plain version: max "
          f"|d| {diff:.4g} of max |logit| {scale:.4g} (bound "
          f"{PREFILL_LOGIT_RTOL} x)", flush=True)
    del logits

    # ---- [serve-tier] the tiered KV pool on the card ----------------------
    # the [serve] phase's parameters and prompts; every page that moves
    # between HBM and the pinned host tier is one guarded K3 launch at the
    # pool's device-mapped address, every tier flush and prefetch-wait one
    # K3 wait, and HostKVTier.step makes no host synchronization
    # PagedKVWindow on the card against the same scenario on the CPU's
    # plain versions, bit for bit: 4 ranks' pools of qwen3-4b layer pages
    # (16 tokens x 8 KV heads x 128, K and V) in float32; a local fill, a
    # handle push, a planned batch push, accumulates on the intrinsic and
    # the tiled route, a handle read, a freed page's stale put and read
    from repro_torch.serve import paged as paged_mod

    def paged_tour(device, kvs, small, big):
        spec = paged_mod.PageSpec(SERVE_PAGE, cfg_serve.n_kv_heads,
                                  cfg_serve.head_dim, 3)
        ring4 = [(r, (r + 1) % 4) for r in range(4)]
        shift4 = [(r, (r + 2) % 4) for r in range(4)]
        kvs, small, big = ([x.to(device) for x in kvs], small.to(device),
                           big.to(device))
        pool = paged_mod.PagedKVWindow.create(spec, "x", 4, torch.float32,
                                              device=device)
        pool.alloc_page(0).alloc_page(1)
        pool.write_page_local(0, kvs[0])
        pool.put_page_remote(1, kvs[1], ring4)
        pool.alloc_page(2)
        pool.push_pages([0, 2], kvs[2:], shift4)
        pool.accumulate_page(1, small, ring4, offset=3)
        pool.accumulate_page(2, big, shift4)
        _, got = pool.get_page_remote(1, ring4)
        stale = pool.handles[:, 1].clone()
        pool.free_page(1)
        mhw = rma_layer.win_from_memhandle(pool.window, stale).put(
            kvs[0].reshape(4, -1)[:, :64], ring4)
        pool.err_count += mhw.err_count
        _, freed = pool.get_page_remote(1, shift4)
        return [t.cpu() for t in (pool.window.buffer, pool.handles,
                                  pool.err_count, got, freed)]

    page_shape = (4, 2, SERVE_PAGE, cfg_serve.n_kv_heads, cfg_serve.head_dim)
    tour_in = ([torch.randn(page_shape) for _ in range(4)],
               torch.randn((4, ATOMIC_COUNT)),
               torch.randn((4, 2 * SERVE_PAGE * cfg_serve.n_kv_heads
                            * cfg_serve.head_dim)))
    on_card_pw = paged_tour(dev, *tour_in)
    on_cpu_pw = paged_tour(torch.device("cpu"), *tour_in)
    check(all(torch.equal(a, b) for a, b in zip(on_card_pw, on_cpu_pw)),
          "PagedKVWindow on the card differs from its plain versions")
    check(on_card_pw[2].tolist() == [2, 2, 2, 2] and not on_card_pw[4].any(),
          "PagedKVWindow: stale operations not dropped, zeroed and counted")
    print("[serve-tier] PagedKVWindow on the card equals the CPU's plain "
          "versions bit for bit (4 ranks x 3 qwen3-4b layer pages, float32):"
          " local fill, handle push, planned batch push, intrinsic and "
          "tiled accumulates, handle read, a freed page's stale put dropped "
          "and read zeroed, 2 counted per rank", flush=True)
    del on_card_pw, on_cpu_pw, tour_in

    pps = SERVE_MAX_SEQ // SERVE_PAGE
    tier_pages = tuple(k * pps for k in TIER_SEQS)
    tier_kw = dict(paged_kv=True, page_tokens=SERVE_PAGE, prefix_share=True)
    gc.collect()
    torch.cuda.empty_cache()
    hbm_eng = ServeEngine(serve_model, serve_params, n_slots=SERVE_SLOTS,
                          max_seq=SERVE_MAX_SEQ, kv_pages=tier_pages[0],
                          **tier_kw)
    for rid in range(TIER_HBM_REQUESTS):
        hbm_eng.submit(Request(rid, prompts[rid], SERVE_NEW))
    hbm_tokens = {c.rid: c.tokens for c in hbm_eng.run(strict=True)}
    check(all(hbm_tokens[r] == serve_out["dense"][r] for r in hbm_tokens),
          "all-HBM paged (kv_pages=256) tokens differ from dense")
    hbm_live = hbm_eng.stats()["max_live"]
    del hbm_eng
    eng = ServeEngine(serve_model, serve_params, n_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, kv_pages=tier_pages, **tier_kw)
    tier = eng.tier
    host_buf = tier.pool.window.buffer
    check(host_buf.is_pinned() and not host_buf.is_cuda
          and tier.pool.handles.is_cuda and tier.pool.window.regs.is_cuda
          and tier.pool.window.substrate.counters.is_cuda,
          "the host tier's pool is not pinned host memory under control "
          "state on the card")
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid, prompt, SERVE_NEW))
    spent = {"prefill": [], "decode": []}
    for part in spent:                # both calls end in a host read
        def timed(*a, _fn=getattr(eng.executor, part), _t=spent[part]):
            t = time.perf_counter()
            out = _fn(*a)
            _t.append((time.perf_counter() - t) * 1e3)
            return out
        setattr(eng.executor, part, timed)
    tier_steps = []
    plain_step = tier.step

    def checked_step(promote, demote, payloads=None):
        """The engine's tier step under set_sync_debug_mode('error'): any
        host synchronization inside it raises; CUDA events around it."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = plain_step(promote, demote, payloads)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        b.record()
        tier_steps.append((a, b, len(promote), len(demote)))
        return out

    tier.step = checked_step
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.run(strict=True)
    wall = time.perf_counter() - t0
    tier.step = plain_step
    k3_variants = dict(K.COUNTERS["ring_put"].by_variant)
    counts = path_counts("serve tier", ("ring_put", "put_wait",
                                        "flash_attention"))
    st = eng.stats()
    moved = st["demotions"] + st["promotions"]
    tokens = {c.rid: c.tokens for c in done}
    check(tokens == serve_out["dense"],
          "tiered greedy tokens differ from the dense engine's")
    check(st["demotions"] > 0 and st["promotions"] > 0,
          f"the tiers never moved a page: {st}")
    check(st["tier_stale_drops"] == 0, f"stale tier reads: {st}")
    check(st["max_live"] >= 2 * hbm_live,
          f"max_live {st['max_live']} < 2 x the all-HBM engine's {hbm_live}")
    check(k3_variants == {"guarded-host": moved},
          f"K3 launches {k3_variants}, want {moved} guarded host ones (the "
          f"pages demoted plus the pages promoted)")
    check(counts["flash_attention"] == cfg_serve.n_layers * SERVE_REQUESTS,
          f"serve tier: K7 launched {counts['flash_attention']} times")
    eng.pool.check_conservation()
    check(eng.pool.n_free == eng.pool.n_pages
          and eng.pool.host.n_free == eng.pool.host.capacity
          and not tier.pool.live.any(),
          f"the tiers did not drain: {st}")
    torch.cuda.synchronize()
    step_ms = sorted(a.elapsed_time(b) for a, b, _, _ in tier_steps)
    n_tok = sum(len(t) for t in tokens.values())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # one sequence each way on the drained tier, by CUDA events, beside
    # copy_ of the same pages between the card and the pinned pool
    e_page = tier.spec.page_elems
    seq_slots = list(range(pps))
    tier.alloc(seq_slots)
    seq_pay = rand((pps, e_page), torch.bfloat16)
    tier.step((), seq_slots, seq_pay)
    check(torch.equal(tier.step(seq_slots, ()), seq_pay),
          "one sequence did not round-trip through the host tier")
    host_seq = host_buf[0, :pps * e_page].view(pps, e_page)
    landed = torch.empty_like(seq_pay)
    seq_ms = dict(
        demote=time_ms(torch, lambda: tier.step((), seq_slots, seq_pay),
                       reps=3),
        promote=time_ms(torch, lambda: tier.step(seq_slots, ()), reps=3),
        demote_copy=time_ms(torch, lambda: host_seq.copy_(
            seq_pay, non_blocking=True), reps=3),
        promote_copy=time_ms(torch, lambda: landed.copy_(
            host_seq, non_blocking=True), reps=3))
    # the steps' K3 work alone: the same guarded launches, one a page at
    # the tier's own handles, back to back in a CUDA graph (card time; a
    # step is host-bound)
    win_h = tier.pool.window
    tgt0 = torch.zeros(1, dtype=torch.int32, device=dev)
    hnds = [tier.pool.handles[:, s].contiguous() for s in seq_slots]

    def k3_seq(read: bool):
        for i, h in enumerate(hnds):
            if read:
                k3.put_rows(win_h.buffer, landed[i:i + 1], tgt0, handles=h,
                            regs=win_h.regs, err=tier.err_count, read=True)
            else:
                k3.put_rows(seq_pay[i:i + 1], win_h.buffer, tgt0, handles=h,
                            regs=win_h.regs, err=tier.err_count)
    landed.zero_()
    k3_seq(True)
    torch.cuda.synchronize()
    check(torch.equal(landed, seq_pay), "the K3 promotes of one sequence "
          "differ from what was demoted")
    seq_ms["demote_k3"] = graph_ms(torch, lambda: k3_seq(False), reps=2)
    seq_ms["promote_k3"] = graph_ms(torch, lambda: k3_seq(True), reps=2)
    check(int(tier.err_count.sum()) == 0, "the timed tier steps went stale")
    tier.free(seq_slots)
    seq_bytes = pps * e_page * 2
    gbs = {k: seq_bytes / v / 1e6 for k, v in seq_ms.items()}
    pre, dec = spent["prefill"], spent["decode"]
    record["ring_put_host"]["tier_seq_ms"] = seq_ms
    print(f"[serve-tier] {cfg_serve.name} x{cfg_serve.n_layers}, "
          f"{SERVE_REQUESTS} requests x {SERVE_PROMPT} prompt tokens, "
          f"{SERVE_NEW} new each, {SERVE_SLOTS} slots, kv_pages="
          f"{tier_pages} of {SERVE_PAGE} tokens, prefix sharing, bf16: greedy "
          f"tokens equal dense bit for bit; {st['demotions']} pages demoted, "
          f"{st['promotions']} promoted, {moved} guarded K3 launches on the "
          f"pinned host window ({counts['put_wait']} waits), 0 stale; "
          f"max_live {st['max_live']} (all-HBM at {tier_pages[0]} pages: "
          f"{hbm_live}); no host synchronization in {len(tier_steps)} "
          f"HostKVTier.step calls; {n_tok} tokens in {wall:.2f} s "
          f"({n_tok / wall:.1f} tok/s), {st['ticks']} ticks; decode ms per "
          f"tick median {sorted(dec)[len(dec) // 2]:.2f} (min {min(dec):.2f},"
          f" max {max(dec):.2f}); tier step ms median "
          f"{step_ms[len(step_ms) // 2]:.2f} (max {step_ms[-1]:.2f}); prefill "
          f"ms per request {[round(x, 1) for x in pre]}; peak device memory "
          f"{peak_gib:.1f} GiB; pinned host pool "
          f"{host_buf.numel() * 2 / 2**30:.2f} GiB ({host_buf.numel() * 2} "
          f"bytes)", flush=True)
    print(f"[serve-tier] one sequence ({pps} pages, "
          f"{seq_bytes / 2**20:.0f} MiB) by CUDA events: demote "
          f"{seq_ms['demote']:.2f} ms ({gbs['demote']:.1f} GB/s), copy_ to "
          f"pinned {seq_ms['demote_copy']:.2f} ms ({gbs['demote_copy']:.1f} "
          f"GB/s); promote {seq_ms['promote']:.2f} ms ({gbs['promote']:.1f} "
          f"GB/s), copy_ from pinned {seq_ms['promote_copy']:.2f} ms "
          f"({gbs['promote_copy']:.1f} GB/s); the steps' {pps} K3 launches "
          f"alone by graph replay: demote {seq_ms['demote_k3']:.2f} ms "
          f"({gbs['demote_k3']:.1f} GB/s), promote "
          f"{seq_ms['promote_k3']:.2f} ms ({gbs['promote_k3']:.1f} GB/s)",
          flush=True)
    del eng, tier, host_buf, host_seq, seq_pay, landed, timed, win_h, hnds
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [serve-disagg] disaggregated prefill -> decode on the card ---------
    # the [serve] phase's model and 8 prompts: each prefilled once, its KV
    # cut into pages in the tier's format (16 tokens x 8 KV heads x 128 x
    # K,V x 36 layers, bf16: 64 pages a prompt); 8 stacked ranks on a ring,
    # 2 sequences each on 2 lanes (rank r pushes prompts r and (r + 4) mod 8)
    # into a decode pool of 2 x 64 pushed + 64 migration + 1 spare pages a
    # rank, through the module's own functions
    from repro_torch.ft.elastic import migrate_pages
    from repro_torch.serve import disagg as dis_mod
    from repro_torch.serve.scheduler import Scheduler

    engine_mod = sys.modules["repro_torch.serve.engine"]
    d_pps = -(-SERVE_PROMPT // SERVE_PAGE)        # 64 pages a prompt
    t0 = time.perf_counter()
    seq_pages = []
    for prompt in prompts:
        tok = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
        _, cache = serve_model.prefill(
            serve_params, {"tokens": tok},
            serve_model.init_cache(1, d_pps * SERVE_PAGE))
        parts = []                      # Executor.gather_page_payloads' walk
        for d in engine_mod._paged_dicts(dis_mod.paginate_cache(
                cache, SERVE_PAGE)):
            for key in ("k_pages", "v_pages"):
                leaf = d[key][:, :d_pps] if d[key].dim() == 5 else \
                    d[key][None, :d_pps]
                parts.append(leaf.movedim(0, 1).reshape(d_pps, -1))
        seq_pages.append(torch.cat(parts, 1))
        del cache, parts
    page_e = seq_pages[0].shape[1]
    check(page_e == SERVE_PAGE * cfg_serve.n_kv_heads * cfg_serve.head_dim
          * 2 * cfg_serve.n_layers and seq_pages[0].dtype == torch.bfloat16,
          f"a prompt's pages are {tuple(seq_pages[0].shape)} "
          f"{seq_pages[0].dtype}")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    nr, n_seq_d, n_lanes_d = DISAGG_RANKS, DISAGG_SEQS, DISAGG_SEQS
    ring8 = [(r, (r + 1) % nr) for r in range(nr)]

    def prompt_of(rank, seq):
        return (rank + (nr // 2) * seq) % nr

    # the pages each sequence index pushes, stacked by rank: (nr, 64, page)
    pushed = [torch.stack([seq_pages[prompt_of(r, s)] for r in range(nr)])
              for s in range(n_seq_d)]
    n_pool = n_seq_d * d_pps + d_pps + 1
    spec_d = paged_mod.PageSpec(page_tokens=page_e // 2, kv_heads=1,
                                head_dim=1, n_pages=n_pool)
    gc.collect()
    torch.cuda.empty_cache()
    pool = paged_mod.PagedKVWindow.create(spec_d, "x", nr, torch.bfloat16,
                                          device=dev)
    ctrl = dis_mod.make_control_window(n_seq_d, "x", nr, n_lanes=n_lanes_d,
                                       device=dev)
    mig_src = list(range(d_pps))                    # sequence 0's pages
    mig_dst = list(range(n_seq_d * d_pps, n_seq_d * d_pps + d_pps))
    # timing taps around the doorbell (the module's put_signal) and the
    # claims: CUDA events on the stream, no host read
    taps: dict[str, list] = {"doorbell": [], "push": [], "claim": []}

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    plain_put_signal = dis_mod.put_signal

    def tapped_put_signal(*a, **kw):
        taps["push"][-1].append(ev())      # the pages' push ends here
        start = ev()
        out = plain_put_signal(*a, **kw)
        taps["doorbell"].append((start, ev()))
        return out

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    # 1. the once-only handle exchange: every target page allocated and
    # registered, the ring's target maps put on the card
    for p in range(n_seq_d * d_pps + d_pps):
        pool.alloc_page(p)
    pool.window.substrate.prepare(ring8)
    ctrl.substrate.prepare(ring8)
    sched_d = Scheduler(n_seq_d, "continuous")
    tickets_d = []
    dis_mod.put_signal = tapped_put_signal
    torch.cuda.set_sync_debug_mode("error")
    try:
        # 2. push every sequence on its lane, its doorbell after the token
        for s in range(n_seq_d):
            taps["push"].append([ev()])
            pool, ctrl = dis_mod.push_sequence(
                pool, ctrl, s, list(range(s * d_pps, (s + 1) * d_pps)),
                [pushed[s][:, i] for i in range(d_pps)], ring8,
                lane=s % n_lanes_d)
        # 3. one thread flush a lane
        for lane in range(n_lanes_d):
            ctrl.flush(stream=lane)
        # 4. admission: one ticket a lane under the continuous policy
        for lane in range(n_lanes_d):
            start = ev()
            ctrl, ts, _ = dis_mod.claim_slots(ctrl, ring8, sched_d, live=0,
                                              lane=lane, max_claims=1)
            ctrl.flush(stream=lane)
            taps["claim"].append((start, ev()))
            tickets_d += ts
    finally:
        torch.cuda.set_sync_debug_mode(0)
        dis_mod.put_signal = plain_put_signal
    host_ms = (time.perf_counter() - t_path) * 1e3
    # 5. the doorbells, then the pages they announce (read after the bell)
    bells = [dis_mod.read_doorbell(ctrl, s) for s in range(n_seq_d)]
    flags_d = torch.stack([b[0] for b in bells], 1).cpu()
    metas_d = torch.stack([b[1] for b in bells], 1).cpu()
    check(bool((flags_d == 1).all()) and bool((metas_d == d_pps).all()),
          f"doorbells {flags_d.tolist()}, meta words {metas_d.tolist()}")
    tickets_h = torch.stack(tickets_d, 1).cpu()
    check(bool((tickets_h == torch.arange(n_lanes_d)).all()),
          f"tickets {tickets_h.tolist()}")
    pool_pages = pool.window.buffer.view(nr, n_pool, page_e)
    for t in range(nr):
        for s in range(n_seq_d):
            check(torch.equal(pool_pages[t, s * d_pps:(s + 1) * d_pps],
                              seq_pages[prompt_of((t - 1) % nr, s)]),
                  f"rank {t}: sequence {s}'s landed pages differ from the "
                  f"prefill's")
    pool_push_phases = pool.window.ledger.total
    # 6. migration of sequence 0's 64 pages to the spare pages (one push on
    # the migration stream), then the sources freed
    stale_handle = pool.handles[:, mig_src[0]].clone()
    m0 = ev()
    pool, n_moved = migrate_pages(pool, zip(mig_src, mig_dst), ring8)
    m1 = ev()
    pool_mig_phases = pool.window.ledger.total
    for p in mig_src:
        pool.free_page(p)
    # 7. one read through a freed source's old handle
    mhw = rma_layer.win_from_memhandle(pool.window, stale_handle)
    mhw, stale = mhw.get(ring8, offset=0, size=page_e)
    stats_d = dis_mod.pool_stats(pool)
    torch.cuda.synchronize()
    counts = path_counts("serve-disagg", ("ring_put", "put_wait",
                                          "put_signal"))
    k3_var = dict(K.COUNTERS["ring_put"].by_variant)
    disagg_launches = {"put_signal_doorbell": counts["put_signal"],
                       "ring_put_page": k3_var.get("guarded", 0)}
    for t in range(nr):
        check(torch.equal(pool_pages[t, mig_dst[0]:mig_dst[-1] + 1],
                          seq_pages[prompt_of((t - 2) % nr, 0)]),
              f"rank {t}: migrated pages differ from the prefill's")
    errs_d = (stats_d["err_count"] + mhw.err_count).cpu()
    check(n_moved == d_pps and not stale.any() and
          errs_d.tolist() == [1] * nr,
          f"stale read: moved {n_moved}, zeroed {not stale.any()}, counted "
          f"{errs_d.tolist()}")
    check(int(stats_d["live_pages"]) == n_seq_d * d_pps,
          f"live pages {int(stats_d['live_pages'])}")
    check(int(pool.window.substrate.stalls.item()) == 0
          and int(ctrl.substrate.stalls.item()) == 0,
          "a flush under a completion token stalled")
    check(pool_push_phases == n_seq_d * (2 * d_pps + 2)
          and pool_mig_phases - pool_push_phases == 2 * d_pps + 2,
          f"the pushes billed {pool_push_phases} phases, the migration "
          f"{pool_mig_phases - pool_push_phases}: want 2 a page + 2 each")
    check(dict(ctrl.ledger.by_kind) == {
        "put": n_seq_d, "accumulate": n_seq_d,
        "flush": 2 * n_lanes_d + 2 * n_lanes_d, "fetch_op": 2 * n_lanes_d},
        f"control window ledger {dict(ctrl.ledger.by_kind)}")
    check(k3_var == {"guarded": n_seq_d * d_pps + d_pps + 1,
                     "static": 2 * n_lanes_d}
          and counts["put_signal"] == n_seq_d,
          f"K3 launches {k3_var}, K4 {counts['put_signal']}: want one "
          f"guarded K3 a page moved (+1 stale read), two a claim, one K4 a "
          f"doorbell")
    ms_d = dict(
        push=[p[0].elapsed_time(p[1]) for p in taps["push"]],
        doorbell=[a.elapsed_time(b) for a, b in taps["doorbell"]],
        claim=[a.elapsed_time(b) for a, b in taps["claim"]],
        migration=m0.elapsed_time(m1))

    # the cross-window edge across CUDA streams: the pool's push on a side
    # stream held by a spin, its doorbell on another stream after= the
    # push's token; as the control, a doorbell with no token (on a window
    # of its own, a third stream) rings while the spin still runs.  The
    # verdict is read from the events' device timestamps, and it means
    # something only if the host issued both doorbells while the spin still
    # ran, which a query right after the last launch shows.  A host held
    # past the spin (a descheduled thread, a collection) voids that try: the
    # edge is made again on fresh windows with a spin twice as long
    xs_kvs = [pushed[1][:, i] for i in range(2)]
    two = torch.full((nr, 1), 2, dtype=torch.int32, device=dev)
    bell_at = dict(data_offset=dis_mod.ctrl_meta_offset(0),
                   flag_offset=dis_mod.ctrl_flag_offset(0))

    def cross_stream_edge(cycles):
        xs_spec = dataclasses.replace(spec_d, n_pages=2)
        xs_pool = paged_mod.PagedKVWindow.create(xs_spec, "x", nr,
                                                 torch.bfloat16, device=dev)
        xs_pool.alloc_page(0).alloc_page(1)
        xs_ctrl, xs_free = (dis_mod.make_control_window(
            1, "x", nr, n_lanes=1, device=dev) for _ in range(2))
        for sub in (xs_pool.window.substrate, xs_ctrl.substrate,
                    xs_free.substrate):
            sub.prepare(ring8)
        torch.cuda.synchronize()
        s_push, s_bell, s_free = (torch.cuda.Stream() for _ in range(3))
        t0 = time.perf_counter()
        with torch.cuda.stream(s_push):
            torch.cuda._sleep(cycles)
            xs_pool.push_pages([0, 1], xs_kvs, ring8)
            token = xs_pool.window.completion_token(0)
            push_done = ev()
        with torch.cuda.stream(s_bell):
            put_signal(xs_ctrl, two, ring8, after=token, **bell_at)
            bell_done = ev()
        with torch.cuda.stream(s_free):
            put_signal(xs_free, two, ring8, **bell_at)
            free_done = ev()
        spinning = not push_done.query()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return (xs_pool, xs_ctrl, xs_free, spinning, issue_ms,
                push_done.elapsed_time(bell_done),
                free_done.elapsed_time(push_done))

    gc.disable()
    try:
        for attempt in range(TOKEN_SPIN_TRIES):
            xs_cycles = TOKEN_SPIN_CYCLES << attempt
            (xs_pool, xs_ctrl, xs_free, spinning, xs_issue_ms, held_ms,
             rang_ms) = cross_stream_edge(xs_cycles)
            if spinning:
                break
            print(f"[serve-disagg] the {xs_cycles}-cycle spin ended before "
                  f"the host had issued the cross-stream edge "
                  f"({xs_issue_ms:.1f} ms): made again with a spin twice as "
                  f"long", flush=True)
    finally:
        gc.enable()
    check(spinning, f"in each of {TOKEN_SPIN_TRIES} tries the spin ended "
          f"before the host had issued the cross-stream edge (the last, "
          f"{xs_cycles} cycles, issued in {xs_issue_ms:.1f} ms): the "
          f"cross-stream check proves nothing")
    check(held_ms >= 0 and rang_ms > 0, f"a doorbell after= a token on "
          f"another stream completed {-held_ms:.3f} ms before the push it "
          f"follows, or one without a token {-rang_ms:.3f} ms after it")
    xs_pages = xs_pool.window.buffer.view(nr, 2, page_e)
    check(xs_ctrl.buffer[:, 1:3].tolist() == [[2, 1]] * nr and all(
        torch.equal(xs_pages[t], pushed[1][(t - 1) % nr, :2])
        for t in range(nr)), "after the cross-stream push the bell and the "
          "pages disagree")
    check(int(xs_pool.window.substrate.stalls.item()) == 0
          and int(xs_ctrl.substrate.stalls.item()) == 0,
          "the cross-stream push's flush stalled")

    # K4 at the doorbell's shape and K3 at a pushed page's, by graph replay,
    # each against its plain version, beside the empty-kernel launch floor,
    # index_copy_ and the byte bound
    tgt8_list = [(r + 1) % nr for r in range(nr)]
    tgt8 = torch.tensor(tgt8_list, dtype=torch.int32, device=dev)
    tgt8_l = tgt8.long()
    count_d = torch.full((nr, 1), d_pps, dtype=torch.int32, device=dev)
    bell_kw = dict(flag=torch.ones((nr, 1), dtype=torch.int32, device=dev),
                   offset=dis_mod.ctrl_meta_offset(0),
                   flag_offset=dis_mod.ctrl_flag_offset(0))
    scr8 = torch.zeros(nr + 2, dtype=torch.int32, device=dev)
    rows_k, rows_p, rows_l = (torch.zeros_like(ctrl.buffer) for _ in range(3))
    k46.put_signal_rows(count_d, rows_k, tgt8, flag_dst=rows_k, scratch=scr8,
                        **bell_kw)
    k46.put_signal_rows_plain(count_d, rows_p, tgt8_list, flag_dst=rows_p,
                              **bell_kw)
    check(torch.equal(rows_k, rows_p), "K4 at the doorbell's shape")
    words = torch.cat([count_d, bell_kw["flag"]], 1)
    floor_d = graph_ms(torch, lambda: empty_launch(torch, programmatic=False))
    record["put_signal_doorbell"] = dict(
        ms=graph_ms(torch, lambda: k46.put_signal_rows(
            count_d, rows_k, tgt8, flag_dst=rows_k, scratch=scr8,
            **bell_kw)),
        plain_ms=graph_ms(torch, lambda: k46.put_signal_rows_plain(
            count_d, rows_p, tgt8_list, flag_dst=rows_p, **bell_kw)),
        library_ms=None, floor_ms=floor_d,
        index_copy_ms=graph_ms(torch, lambda: rows_l[:, 1:3].index_copy_(
            0, tgt8_l, words)),
        path_ms=ms_d, max_abs_err=0.0, shape=[nr, 1], dtype="int32")
    # payload and flag read, meta word written, flag word read and written
    record["put_signal_doorbell"]["bound_ms"], \
        record["put_signal_doorbell"]["bound_by"] = bound_ms(5 * nr * 4)
    page_src = pushed[0][:, 0].contiguous()
    hnd_d = xs_pool.handles[:, 1].contiguous()
    regs_d = xs_pool.window.regs
    xs_buf = xs_pool.window.buffer
    got_k, got_p, got_l = (xs_buf.clone() for _ in range(3))
    errs3 = [torch.zeros(nr, dtype=torch.int32, device=dev) for _ in range(2)]
    k3.put_rows(page_src, got_k, tgt8, handles=hnd_d, regs=regs_d,
                err=errs3[0])
    k3.put_rows_plain(page_src, got_p, tgt8_list, handles=hnd_d,
                      regs=regs_d, err=errs3[1])
    lib_rows = got_l[:, page_e:]
    lib_rows.index_copy_(0, tgt8_l, page_src)
    check(torch.equal(got_k, got_p) and torch.equal(got_l, got_p)
          and errs3[0].sum().item() == 0 == errs3[1].sum().item(),
          "K3 at the page shape differs from its plain version or "
          "index_copy_")
    record["ring_put_page"] = dict(
        ms=graph_ms(torch, lambda: k3.put_rows(
            page_src, got_k, tgt8, handles=hnd_d, regs=regs_d,
            err=errs3[0])),
        plain_ms=time_ms(torch, lambda: k3.put_rows_plain(
            page_src, got_p, tgt8_list, handles=hnd_d, regs=regs_d,
            err=errs3[1]), reps=3),
        library_ms=graph_ms(torch, lambda: lib_rows.index_copy_(
            0, tgt8_l, page_src)),
        copy_ms=graph_ms(torch, lambda: lib_rows.copy_(page_src)),
        floor_ms=floor_d, max_abs_err=0.0, shape=[nr, page_e],
        dtype="bfloat16")
    # each page read once and written once, plus the handle and live
    # registration words of every origin
    record["ring_put_page"]["bound_ms"], record["ring_put_page"]["bound_by"] = \
        bound_ms(2 * nr * page_e * 2 + 20 * nr)
    rd, rp = record["put_signal_doorbell"], record["ring_put_page"]
    print(f"[serve-disagg] {cfg_serve.name} x{cfg_serve.n_layers}: "
          f"{SERVE_REQUESTS} prompts of {SERVE_PROMPT} tokens prefilled in "
          f"{prefill_s:.2f} s and cut into {d_pps} pages of {page_e} bf16 "
          f"({page_e * 2} bytes); {nr} stacked ranks on a ring, "
          f"{n_seq_d} sequences each on {n_lanes_d} lanes, a pool of "
          f"{n_pool} pages a rank ({n_pool * page_e} elements, "
          f"{nr * n_pool * page_e * 2 / 2**30:.2f} GiB): every landed and "
          f"migrated page equals the prefill's bit for bit; bells 1, meta "
          f"words {d_pps}, tickets {tickets_h[0].tolist()} on every rank; "
          f"the stale read zeroed and counted once a rank; live pages "
          f"{int(stats_d['live_pages'])}; 0 stalls; ledger: pushes "
          f"{pool_push_phases} phases (2 a page + 2 each), migration "
          f"{pool_mig_phases - pool_push_phases}, control window "
          f"{dict(ctrl.ledger.by_kind)}; no host synchronization from the "
          f"first push to the last claim ({host_ms:.1f} ms of host clock); "
          f"K3 {k3_var}, K4 {counts['put_signal']}", flush=True)
    print(f"[serve-disagg] CUDA events: a sequence's push (64 pages) "
          f"{[round(x, 3) for x in ms_d['push']]} ms, its doorbell "
          f"{[round(x, 4) for x in ms_d['doorbell']]} ms, a claim + lane "
          f"flush {[round(x, 4) for x in ms_d['claim']]} ms, the migration "
          f"of 64 pages {ms_d['migration']:.3f} ms; the cross-window edge "
          f"held across CUDA streams (the doorbell after= the token waited "
          f"for a {xs_cycles}-cycle spin and completed {held_ms:.3f} ms "
          f"after the push, the one without a token rang {rang_ms:.3f} ms "
          f"before it; edge issued in {xs_issue_ms:.1f} ms of host clock)",
          flush=True)
    print(f"[serve-disagg] graph replay: K4 doorbell {list(rd['shape'])} "
          f"int32 {rd['ms']:.4f} ms (plain {rd['plain_ms']:.4f}, index_copy_ "
          f"of the two words {rd['index_copy_ms']:.4f}, empty launch "
          f"{floor_d:.4f}, bound {rd['bound_ms']:.6f}); K3 guarded page put "
          f"{list(rp['shape'])} bf16 {rp['ms']:.4f} ms (plain "
          f"{rp['plain_ms']:.4f} by calls, index_copy_ "
          f"{rp['library_ms']:.4f}, copy_ {rp['copy_ms']:.4f}, bound "
          f"{rp['bound_ms']:.4f})", flush=True)
    del pool, ctrl, xs_pool, xs_ctrl, xs_free, pushed, mhw, stale, got_k, \
        got_p, got_l, lib_rows, xs_buf, xs_pages, page_src, pool_pages, \
        xs_kvs, seq_pages
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [serve-elastic] the elastic runtime over the paged + COW engine --
    # the [serve] requests through ElasticServing with worker 1 (slots 2,
    # 3) dead at tick 4: its sequences requeue and re-prefill, its slots go
    # offline, its tickets are released
    from repro_torch.ft.elastic import EVICTED, ElasticServing
    from repro_torch.ft.inject import FaultScript

    eng = ServeEngine(serve_model, serve_params, n_slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, paged_kv=True,
                      page_tokens=SERVE_PAGE, prefix_share=True)
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid, prompt, SERVE_NEW))
    es = ElasticServing(eng, FaultScript.parse(ELASTIC_SCRIPT), n_workers=2)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = es.run()
    wall = time.perf_counter() - t0
    counts = path_counts("serve elastic", ("flash_attention",))
    tokens = {c.rid: c.tokens for c in done}
    st = es.stats()
    check(tokens == serve_out["dense"],
          "elastic greedy tokens differ from the dense engine's")
    check(st["elastic"]["workers"][1] == EVICTED and st["offline_slots"] == 2
          and st["evictions"] >= 1, f"elastic stats {st}")
    eng.pool.check_conservation()
    check(eng.pool.n_free == eng.pool.n_pages
          and eng.scheduler.outstanding_claims() == 0,
          f"the pool did not drain or claims are outstanding: {st}")
    rep = es.controller.reports[0]
    n_tok = sum(len(t) for t in tokens.values())
    print(f"[serve-elastic] {cfg_serve.name} x{cfg_serve.n_layers}, "
          f"{SERVE_REQUESTS} requests x {SERVE_PROMPT} prompt tokens, "
          f"{SERVE_NEW} new each, {SERVE_SLOTS} slots on 2 workers, paged + "
          f"COW, script {ELASTIC_SCRIPT!r}: greedy tokens equal dense bit "
          f"for bit; workers {st['elastic']['workers']}, evictions "
          f"{st['evictions']}, offline slots {st['offline_slots']}, pool "
          f"conserved, no claim outstanding; {st['ticks']} ticks, {n_tok} "
          f"tokens in {wall:.2f} s ({n_tok / wall:.1f} tok/s), K7 launched "
          f"{counts['flash_attention']} times ({counts['flash_attention'] // cfg_serve.n_layers} "
          f"prefills); recovery at tick {rep.tick} ({rep.reason}): "
          f"{rep.requeued} sequences requeued, {rep.dropped_count} plans "
          f"dropped, topology {rep.old_topology} -> {rep.new_topology}, "
          f"{rep.duration_s * 1e3:.2f} ms", flush=True)
    del eng, es
    gc.collect()
    torch.cuda.empty_cache()
    del serve_params
    torch.cuda.empty_cache()

    # serving a Mamba2 stack: mamba2-370m at all 48 layers, a dense engine
    # (its caches are the conv tail and the SSM state: nothing to page)
    ssm_model = build_model(cfg_ssm)
    t0 = time.perf_counter()
    ssm_params = ssm_model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_ssm = sum(p.numel() for p in leaves(ssm_params))
    print(f"[plan] {cfg_ssm.name} x{cfg_ssm.n_layers} layers d"
          f"{cfg_ssm.d_model}, {ssm_h} heads x {ssm_p}, d_state {ssm_n}, "
          f"chunk {ssm_q}: {n_ssm} float32 parameters "
          f"({n_ssm * 4 / 2**30:.2f} GiB) initialized on the card from seed "
          f"0 in {time.perf_counter() - t0:.1f} s", flush=True)
    prng = np.random.RandomState(1)
    ssm_prompts = [prng.randint(0, cfg_ssm.vocab, size=SSM_PROMPT)
                   for _ in range(SSM_REQUESTS)]
    eng = ServeEngine(ssm_model, ssm_params, n_slots=SSM_SLOTS,
                      max_seq=SSM_MAX_SEQ)
    for rid, prompt in enumerate(ssm_prompts):
        eng.submit(Request(rid, prompt, SSM_NEW))
    spent = {"prefill": [], "decode": []}
    for part in spent:                # both calls end in a host read
        def timed(*a, _fn=getattr(eng.executor, part), _t=spent[part]):
            t = time.perf_counter()
            out = _fn(*a)
            _t.append((time.perf_counter() - t) * 1e3)
            return out
        setattr(eng.executor, part, timed)
    # the engines above live on in reference cycles (each timed executor
    # method holds its executor): collect them so that the peak is this one's
    del timed
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.run(strict=True)
    wall = time.perf_counter() - t0
    counts = path_counts("serve-ssm dense", ("ssd_intra_chunk", "ssd_pass"))
    n_prefill = len(spent["prefill"])
    check(n_prefill == SSM_REQUESTS, f"serve-ssm: {n_prefill} prefills")
    for name in ("ssd_intra_chunk", "ssd_pass"):
        check(counts[name] == cfg_ssm.n_layers * n_prefill,
              f"serve-ssm: {name} launched {counts[name]} times, want "
              f"{cfg_ssm.n_layers} x {n_prefill} prefills")
    tokens = {c.rid: c.tokens for c in done}
    check(sorted(tokens) == list(range(SSM_REQUESTS)) and all(
        len(t) == SSM_NEW and all(0 <= x < cfg_ssm.vocab for x in t)
        for t in tokens.values()), f"serve-ssm: tokens {tokens}")
    n_tok = sum(len(t) for t in tokens.values())
    pre, dec = spent["prefill"], spent["decode"]
    print(f"[serve-ssm] dense: {SSM_REQUESTS} requests x {SSM_PROMPT} prompt "
          f"tokens, {SSM_NEW} new each, {SSM_SLOTS} slots, max_seq "
          f"{SSM_MAX_SEQ}, bf16: {n_tok} tokens in {wall:.2f} s "
          f"({n_tok / wall:.1f} tok/s); prefill ms per request "
          f"{[round(x, 1) for x in pre]}; decode ms per tick median "
          f"{sorted(dec)[len(dec) // 2]:.2f} (min {min(dec):.2f}, max "
          f"{max(dec):.2f}, {len(dec)} ticks); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; stats "
          f"{eng.stats()}", flush=True)
    del eng
    # one prefill on the card scan (K8 + pass) against the same prefill on
    # their plain composition, and one decode step after it
    tok = torch.as_tensor(ssm_prompts[0], dtype=torch.int64, device=dev)[None]
    logits = {}
    card_scan = ops_mod.ssd_scan
    for name, fn in (("kernels", card_scan), ("plain", ops_mod.ssd_scan_plain)):
        ops_mod.ssd_scan = fn
        try:
            logits[name], cache = ssm_model.prefill(
                ssm_params, {"tokens": tok},
                ssm_model.init_cache(1, SSM_MAX_SEQ))
        finally:
            ops_mod.ssd_scan = card_scan
    step_logits, _ = ssm_model.decode_step(
        ssm_params, cache, logits["kernels"][:, -1].argmax(-1, keepdim=True))
    lanes = slice(0, cfg_ssm.vocab)       # the padded lanes hold -1e30
    diff = (logits["kernels"][..., lanes] - logits["plain"][..., lanes]
            ).abs().max().item()
    scale = logits["plain"][..., lanes].abs().max().item()
    check(bool(torch.isfinite(logits["kernels"][..., lanes]).all())
          and bool(torch.isfinite(step_logits[..., lanes]).all()),
          "Mamba2 prefill or decode logits not finite")
    check(diff <= SSM_LOGIT_RTOL * scale,
          f"Mamba2 prefill logits on K8 + pass vs their plain versions: max "
          f"|d| {diff} of max |logit| {scale}")
    print(f"[serve-ssm] one prefill's last logits, K8 + pass vs their plain "
          f"versions: "
          f"max |d| {diff:.4g} of max |logit| {scale:.4g} (bound "
          f"{SSM_LOGIT_RTOL} x); the next decode step's logits finite",
          flush=True)
    del ssm_params, logits, cache, step_logits
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [train-ssm] mamba2-370m trains on the card -------------------------
    # all 48 layers at published widths, 4 stacked data-parallel ranks with
    # the one-sided ring: a Mamba2 block whose inputs require grad calls
    # models.ssm.ssd_chunked (the reference's training path), so no K8 or
    # pass launch happens in a step; a no-grad prefill of the trained model
    # launches each once a layer
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = train(SSM_ARCH, tiny=False, steps=SSM_TRAIN_STEPS,
                global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, peak_lr=1e-3,
                warmup_steps=0, grad_sync="rma_ring", dp_ranks=n,
                device="cuda", log_every=1)
    counts = path_counts("mamba2-370m step", ("ring_all_reduce", "put_wait"))
    check(all(v == v and abs(v) < 1e6 for v in run.losses),
          f"train-ssm: loss not finite: {run.losses}")
    check(run.losses[-1] < run.losses[0],
          f"train-ssm: loss did not fall: {run.losses}")
    check(counts["ring_all_reduce"] == SSM_TRAIN_STEPS,
          f"train-ssm: K5 launched {counts['ring_all_reduce']} times in "
          f"{SSM_TRAIN_STEPS} steps")
    check(counts["ssd_intra_chunk"] == counts["ssd_pass"] == 0,
          f"train-ssm: K8 or the pass launched in a train step: {counts}")
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    ring_ms = [round(p["sync"], 2) for p in run.part_ms]
    parts = [{k: round(v, 2) for k, v in p.items()} for p in run.part_ms]
    K.reset_launch_counts()
    tok = torch.as_tensor(ssm_prompts[0][:SEQ_LEN], dtype=torch.int64,
                          device=dev)[None]
    with torch.no_grad():
        trained_logits, _ = ssm_model.prefill(
            run.params, {"tokens": tok}, ssm_model.init_cache(1, SEQ_LEN))
    counts = path_counts("mamba2-370m no-grad prefill of the trained model",
                         ("ssd_intra_chunk", "ssd_pass"))
    check(counts["ssd_intra_chunk"] == counts["ssd_pass"]
          == cfg_ssm.n_layers,
          f"train-ssm: the trained model's prefill launched {counts}, want "
          f"K8 and the pass {cfg_ssm.n_layers} times each")
    check(bool(torch.isfinite(trained_logits[..., :cfg_ssm.vocab]).all()),
          "train-ssm: the trained model's prefill logits not finite")
    print(f"[train-ssm] {SSM_ARCH} d{cfg_ssm.d_model} x{cfg_ssm.n_layers} "
          f"layers, {n} ranks, batch {GLOBAL_BATCH}x{SEQ_LEN} bf16, "
          f"remat={cfg_ssm.remat}, {run.n_params} parameters: losses "
          f"{[round(v, 4) for v in run.losses]}; step ms "
          f"{[round(v, 1) for v in run.step_ms]}; ring ms (CUDA events) "
          f"{ring_ms}; parts ms {parts}; peak memory {train_peak:.1f} GiB; "
          f"K5 once "
          f"a step, no K8 or pass launch in a step; the trained model's "
          f"no-grad prefill on K8 and the pass {cfg_ssm.n_layers} times each "
          f"({smi})", flush=True)
    del run, trained_logits, ssm_model
    gc.collect()
    torch.cuda.empty_cache()
    # one more step without remat: what rematerializing buys where the
    # activations dominate
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = train(SSM_ARCH, tiny=False, steps=1, global_batch=GLOBAL_BATCH,
                seq_len=SEQ_LEN, peak_lr=1e-3, warmup_steps=0,
                grad_sync="rma_ring", dp_ranks=n, remat="none",
                device="cuda", log_every=1)
    counts = path_counts("mamba2-370m step, remat none",
                         ("ring_all_reduce", "put_wait"))
    check(counts["ring_all_reduce"] == 1
          and counts["ssd_intra_chunk"] == counts["ssd_pass"] == 0,
          f"train-ssm remat none: launches {counts}")
    check(all(v == v and abs(v) < 1e6 for v in run.losses),
          f"train-ssm remat none: loss not finite: {run.losses}")
    none_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train-ssm] remat=none, one step: {run.step_ms[0]:.1f} ms, peak "
          f"memory {none_peak:.1f} GiB, against remat=block's "
          f"{train_peak:.1f} GiB ({smi})", flush=True)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [train-ckpt] checkpoint, preemption and resume on the card ---------
    # mamba2-370m at published widths, depth cut to CKPT_LAYERS of 48, 4
    # stacked data-parallel ranks with the ring (K5 once a step): an
    # uninterrupted run of CKPT_STEPS steps saving every CKPT_EVERY (the
    # newest CKPT_KEEP kept), a run preempted at CKPT_FAIL_AT, and its
    # resume from the latest checkpoint, in a temporary directory removed
    # at the end
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.train.optimizer import init_opt_state

    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt_kw = dict(tiny=False, n_layers=CKPT_LAYERS, steps=CKPT_STEPS,
                       global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                       peak_lr=1e-3, warmup_steps=0, grad_sync="rma_ring",
                       dp_ranks=n, ckpt_every=CKPT_EVERY,
                       ckpt_keep=CKPT_KEEP, device="cuda", log_every=1)
        K.reset_launch_counts()
        ref_run = train(SSM_ARCH, ckpt_dir=os.path.join(ckpt_root, "a"),
                        **ckpt_kw)
        counts = path_counts("mamba2-370m x8 checkpointed run",
                             ("ring_all_reduce",))
        check(counts["ring_all_reduce"] == CKPT_STEPS,
              f"train-ckpt: K5 launched {counts['ring_all_reduce']} times "
              f"in {CKPT_STEPS} steps")
        mgr = CheckpointManager(os.path.join(ckpt_root, "a"), keep=CKPT_KEEP)
        kept = sorted(int(d) for d in os.listdir(mgr.dir))
        want_kept = list(range(CKPT_EVERY, CKPT_STEPS + 1,
                               CKPT_EVERY))[-CKPT_KEEP:]
        check(kept == want_kept, f"train-ckpt: kept {kept}, want "
              f"{want_kept}")
        K.reset_launch_counts()
        try:
            train(SSM_ARCH, ckpt_dir=os.path.join(ckpt_root, "b"),
                  fail_at_step=CKPT_FAIL_AT, **ckpt_kw)
            preempted = ""
        except RuntimeError as err:
            preempted = str(err)
        check(preempted == f"simulated preemption at step {CKPT_FAIL_AT}",
              f"train-ckpt: the preemption did not happen: {preempted!r}")
        counts = path_counts("mamba2-370m x8 run preempted",
                             ("ring_all_reduce",))
        check(counts["ring_all_reduce"] == CKPT_FAIL_AT,
              f"train-ckpt: K5 launched {counts['ring_all_reduce']} times "
              f"before the preemption at {CKPT_FAIL_AT}")
        K.reset_launch_counts()
        res_run = train(SSM_ARCH, ckpt_dir=os.path.join(ckpt_root, "b"),
                        resume=True, **ckpt_kw)
        counts = path_counts("mamba2-370m x8 resumed run",
                             ("ring_all_reduce",))
        check(counts["ring_all_reduce"] == CKPT_STEPS - CKPT_FAIL_AT
              and res_run.steps_run == CKPT_STEPS - CKPT_FAIL_AT,
              f"train-ckpt: the resumed run launched K5 "
              f"{counts['ring_all_reduce']} times in {res_run.steps_run} "
              f"steps")
        tail = ref_run.losses[CKPT_FAIL_AT:]
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(res_run.losses, tail))
        check(all(v == v for v in res_run.losses)
              and loss_rel <= CKPT_LOSS_RTOL,
              f"train-ckpt: resumed losses {res_run.losses} vs the "
              f"uninterrupted run's {tail}")
        # the final checkpoint restored onto the card: bit for bit the
        # parameters the run ended with
        like = {"params": ref_run.params,
                "opt": init_opt_state(ref_run.params)}
        state = mgr.restore(CKPT_STEPS, like)
        check(all(a.dtype == b.dtype and a.device == b.device
                  and torch.equal(a, b) for a, b in
                  zip(leaves(state["params"]), leaves(ref_run.params))),
              "train-ckpt: restored parameters differ from the saved ones")
        check(int(state["opt"]["step"]) == CKPT_STEPS,
              f"train-ckpt: restored optimizer step {state['opt']['step']}")
        del like
        # one save of that state timed: the host copy (before save
        # returns), then the thread's write and commit
        timer = CheckpointManager(os.path.join(ckpt_root, "c"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.save(CKPT_STEPS, state)
        returned_ms = (time.perf_counter() - t0) * 1e3
        timer.wait()
        st = timer.stats
        print(f"[train-ckpt] {SSM_ARCH} x{CKPT_LAYERS} of 48 layers, {n} "
              f"ranks, batch {GLOBAL_BATCH}x{SEQ_LEN}: {CKPT_STEPS} steps "
              f"saving every {CKPT_EVERY} (kept {kept}), losses "
              f"{[round(v, 6) for v in ref_run.losses]}; preempted at step "
              f"{CKPT_FAIL_AT} and resumed: losses "
              f"{[round(v, 6) for v in res_run.losses]}, max relative "
              f"difference {loss_rel:.3g} (bound {CKPT_LOSS_RTOL}); K5 once "
              f"a step in all three runs; the restored parameters equal the "
              f"saved bit for bit; step ms "
              f"{[round(v, 1) for v in ref_run.step_ms]}; a checkpoint "
              f"(parameters + AdamW state) "
              f"{st['bytes']} bytes, save: host copy {st['copy_ms']:.1f} ms "
              f"(save returned after {returned_ms:.1f} ms), the thread's "
              f"write {st['write_ms']:.1f} ms ({smi})", flush=True)
        del state, ref_run, res_run, timer, mgr
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    check(not os.path.exists(ckpt_root), "train-ckpt: directory left")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [compress] error-feedback compressed all-reduce on the card --------
    # mamba2-370m's gradient size, (4, P) float32 rows from the seed (row r
    # rank r's gradient, its residual beside it), for int8 and top-k at
    # 1 %: one K5 launch a call, the result bit for bit the restored rows
    # summed by K5's plain version, the residual exact, the int8 payload of
    # a slice bit for bit the CPU's, the wire ratios
    from repro_torch.core.rma import plan_all_reduce
    from repro_torch.train import compress as comp

    p_ssm = sum(p.numel() for p in leaves(
        build_model(cfg_ssm).init(0, device="meta")))
    check(p_ssm == SSM_PARAMS, f"compress: mamba2-370m has {p_ssm} "
          f"parameters, want {SSM_PARAMS}")
    g_rows = torch.randn((n, p_ssm), generator=gen, device=dev)
    e_rows = torch.randn((n, p_ssm), generator=gen, device=dev) * 0.01
    sl = slice(0, 1 << 20)
    # the wire bytes over float32's: int8 values and one float32 scale;
    # top-k's k float32 values and k int32 indices
    k_top = max(1, int(p_ssm * 0.01))
    for scheme, frac, ratio_want in (
            ("int8", 0.01, (p_ssm + 4) / (4 * p_ssm)),
            ("topk", 0.01, 8 * k_top / (4 * p_ssm))):
        ccfg = comp.CompressionConfig(scheme=scheme, topk_frac=frac)
        K.reset_launch_counts()
        red, new_err = comp.compressed_all_reduce(g_rows, e_rows, ccfg,
                                                  "data", n)
        torch.cuda.synchronize()
        counts = path_counts(f"compressed all-reduce, {scheme}",
                             ("ring_all_reduce",))
        check(counts["ring_all_reduce"] == 1,
              f"compress {scheme}: K5 launched {counts['ring_all_reduce']} "
              f"times in one call")
        # the same compression again, row by row and timed: residuals bit
        # for bit, restored + residual = g + err to float32 rounding
        restored = torch.empty_like(g_rows)
        a_ev = torch.cuda.Event(enable_timing=True)
        b_ev = torch.cuda.Event(enable_timing=True)
        comp_ms = 0.0
        for r in range(n):
            a_ev.record()
            payload, e, rest = comp.compress_with_feedback(
                g_rows[r], e_rows[r], ccfg)
            b_ev.record()
            torch.cuda.synchronize()
            comp_ms += a_ev.elapsed_time(b_ev)
            restored[r] = rest
            if r == 0:
                ratio = comp.compression_ratio(g_rows[0], payload)
            check(torch.equal(e, new_err[r]),
                  f"compress {scheme}: row {r}'s residual differs between "
                  f"two calls")
            g32 = g_rows[r] + e_rows[r]
            slack = (rest + e - g32).abs() - 2.0 ** -23 * (
                g32.abs() + e.abs())
            check(float(slack.max()) <= 0,
                  f"compress {scheme}: restored + residual != g + err")
            del payload, e, rest, g32, slack
        check(ratio == ratio_want,
              f"compress {scheme}: ratio {ratio}, want {ratio_want}")
        plain = k5.ring_all_reduce_plain(restored) / n
        check(torch.equal(plain, red),
              f"compress {scheme}: the result differs from the restored "
              f"rows summed by K5's plain version")
        del plain, red, new_err
        # the ring alone, timed (not a main-path launch)
        a_ev.record()
        plan_all_reduce(restored, "data", n, order=True, donate=True)
        b_ev.record()
        torch.cuda.synchronize()
        ring_ms = a_ev.elapsed_time(b_ev)
        del restored
        if scheme == "int8":
            piece = g_rows[0, sl] + e_rows[0, sl]
            q, scale = comp.int8_compress(piece)
            q_cpu, scale_cpu = comp.int8_compress(piece.cpu())
            check(torch.equal(q.cpu(), q_cpu)
                  and torch.equal(scale.cpu(), scale_cpu),
                  "compress int8: the card's payload of a slice differs "
                  "from the CPU's")
            del piece, q, scale
        print(f"[compress] {scheme}{f' {frac:g}' if scheme == 'topk' else ''}"
              f" on ({n}, {p_ssm}) float32 ({SSM_ARCH}'s gradient size): K5 "
              f"once a call; the result bit for bit the restored rows "
              f"summed by K5's plain version; residuals equal across calls, "
              f"restored + residual = g + err to float32 rounding; wire "
              f"ratio {ratio:.9f}; compress {comp_ms:.2f} ms for {n} rows, "
              f"the ring {ring_ms:.2f} ms (CUDA events; {smi})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[compress] the int8 payload (q, scale) of a {sl.stop}-float "
          f"slice on the card equals the CPU's bit for bit", flush=True)
    del g_rows, e_rows
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [serve-hybrid] jamba-v0.1-52b served on the card -------------------
    # published widths, depth cut to one period (8 of 32 layers: 7 Mamba2,
    # 1 attention, 4 MoE of all 16 experts), parameters made on the card
    # from seed 0; the [serve] request set through a dense engine and a
    # paged engine with copy-on-write prefix sharing.  Each prefill runs K7
    # once (the attention layer) and K8 and the pass once a Mamba2 layer;
    # the MoE layers serve in ep_mode="gspmd", as the JAX launcher does
    cfg_hyb = cfg_hyb.replace(n_layers=HYBRID_LAYERS)
    hyb_model = build_model(cfg_hyb)
    n_attn = sum(sp.mixer == "gqa" for sp in hyb_model.plan)
    n_mamba = sum(sp.mixer == "mamba" for sp in hyb_model.plan)
    n_moe = sum(sp.ffn == "moe" for sp in hyb_model.plan)
    check((n_attn, n_mamba, n_moe) == (1, 7, 4),
          f"jamba x{HYBRID_LAYERS}: {n_attn} attention, {n_mamba} Mamba2, "
          f"{n_moe} MoE layers")
    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    hyb_params = hyb_model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_hyb = sum(p.numel() for p in leaves(hyb_params))
    print(f"[plan] {cfg_hyb.name} x{cfg_hyb.n_layers} of 32 layers d"
          f"{cfg_hyb.d_model} ({n_attn} attention GQA {cfg_hyb.n_heads}/"
          f"{cfg_hyb.n_kv_heads}, {n_mamba} Mamba2 {hyb_h}x{hyb_p} d_state "
          f"{hyb_n}, {n_moe} MoE of {cfg_hyb.moe.num_experts} experts top "
          f"{cfg_hyb.moe.top_k}): {n_hyb} float32 parameters "
          f"({n_hyb * 4 / 2**30:.1f} GiB) initialized on the card from seed "
          f"0 in {time.perf_counter() - t0:.1f} s ({held_before:.2f} GiB "
          f"held before)", flush=True)
    prng = np.random.RandomState(0)
    prefix = prng.randint(0, cfg_hyb.vocab, size=SERVE_PREFIX)
    hyb_prompts = [np.concatenate([prefix, prng.randint(
        0, cfg_hyb.vocab, size=SERVE_PROMPT - SERVE_PREFIX)])
        for _ in range(3)]
    hyb_prompts.append(hyb_prompts[2].copy())
    hyb_prompts += [prng.randint(0, cfg_hyb.vocab, size=SERVE_PROMPT)
                    for _ in range(SERVE_REQUESTS - len(hyb_prompts))]
    hyb_out = {}
    for mode, kw in (("dense", {}),
                     ("paged+cow", dict(paged_kv=True, page_tokens=SERVE_PAGE,
                                        prefix_share=True))):
        eng = ServeEngine(hyb_model, hyb_params, n_slots=SERVE_SLOTS,
                          max_seq=SERVE_MAX_SEQ, **kw)
        for rid, prompt in enumerate(hyb_prompts):
            eng.submit(Request(rid, prompt, SERVE_NEW))
        spent = {"prefill": [], "decode": []}
        for part in spent:            # both calls end in a host read
            def timed(*a, _fn=getattr(eng.executor, part), _t=spent[part]):
                t = time.perf_counter()
                out = _fn(*a)
                _t.append((time.perf_counter() - t) * 1e3)
                return out
            setattr(eng.executor, part, timed)
        del timed
        K.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run(strict=True)
        wall = time.perf_counter() - t0
        counts = path_counts(f"serve-hybrid {mode}", (
            "flash_attention", "ssd_intra_chunk", "ssd_pass"))
        n_prefill = len(spent["prefill"])
        check(n_prefill == SERVE_REQUESTS,
              f"serve-hybrid {mode}: {n_prefill} prefills")
        for name, per in (("flash_attention", n_attn),
                          ("ssd_intra_chunk", n_mamba),
                          ("ssd_pass", n_mamba)):
            check(counts[name] == per * n_prefill,
                  f"serve-hybrid {mode}: {name} launched {counts[name]} "
                  f"times, want {per} x {n_prefill} prefills")
        check(k7.COUNTER.by_variant == {
            k7.VARIANTS[torch.bfloat16]: counts["flash_attention"]},
              f"serve-hybrid {mode}: K7 variants {k7.COUNTER.by_variant}")
        hybrid_launches = {"ssd_intra_chunk_n16": counts["ssd_intra_chunk"],
                           "ssd_pass_n16": counts["ssd_pass"]}
        tokens = {c.rid: c.tokens for c in done}
        check(sorted(tokens) == list(range(SERVE_REQUESTS)) and all(
            len(t) == SERVE_NEW and all(0 <= x < cfg_hyb.vocab for x in t)
            for t in tokens.values()), f"serve-hybrid {mode}: {tokens}")
        st = eng.stats()
        if eng.paged_kv:
            eng.pool.check_conservation()
            check(st["cow_copies"] > 0 and st["pages_shared"] > 0,
                  f"serve-hybrid {mode}: no page was shared or forked: {st}")
            check(eng.pool.n_free == eng.pool.n_pages,
                  f"serve-hybrid {mode}: pages still held: {st}")
            check(eng.executor.page_payload_elems == SERVE_PAGE
                  * cfg_hyb.n_kv_heads * cfg_hyb.head_dim * 2 * n_attn,
                  f"serve-hybrid: a page payload of "
                  f"{eng.executor.page_payload_elems} elements is not the "
                  f"attention layer's KV alone")
        n_tok = sum(len(t) for t in tokens.values())
        hyb_out[mode] = tokens
        pre, dec = spent["prefill"], spent["decode"]
        print(f"[serve-hybrid] {mode}: {SERVE_REQUESTS} requests x "
              f"{SERVE_PROMPT} prompt tokens, {SERVE_NEW} new each, "
              f"{SERVE_SLOTS} slots, max_seq {SERVE_MAX_SEQ}, bf16: {n_tok} "
              f"tokens in {wall:.2f} s ({n_tok / wall:.1f} tok/s); prefill "
              f"ms per request {[round(x, 1) for x in pre]}; decode ms per "
              f"tick median {sorted(dec)[len(dec) // 2]:.2f} (min "
              f"{min(dec):.2f}, max {max(dec):.2f}, {len(dec)} ticks); peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"launches {counts}; stats {st} ({smi})", flush=True)
        del eng, done
        gc.collect()
    check(hyb_out["dense"] == hyb_out["paged+cow"],
          "serve-hybrid: dense and paged+COW greedy tokens differ")
    print("[serve-hybrid] dense and paged+COW greedy tokens equal bit for "
          "bit", flush=True)
    # one prefill on K7, K8 and the pass against the same prefill on their
    # plain versions, and one decode step after it
    tok = torch.as_tensor(hyb_prompts[0], dtype=torch.int64,
                          device=dev)[None]
    logits = {}
    card_scan = ops_mod.ssd_scan
    for name, attn_fn, scan_fn in (
            ("kernels", k7.flash_attention, card_scan),
            ("plain", k7.flash_attention_plain, ops_mod.ssd_scan_plain)):
        attn_mod.flash_attention, ops_mod.ssd_scan = attn_fn, scan_fn
        try:
            logits[name], cache = hyb_model.prefill(
                hyb_params, {"tokens": tok},
                hyb_model.init_cache(1, SERVE_MAX_SEQ))
        finally:
            attn_mod.flash_attention = k7.flash_attention
            ops_mod.ssd_scan = card_scan
        if name == "kernels":
            step_logits, _ = hyb_model.decode_step(
                hyb_params, cache,
                logits["kernels"][:, -1].argmax(-1, keepdim=True))
    lanes = slice(0, cfg_hyb.vocab)
    diff = (logits["kernels"][..., lanes] - logits["plain"][..., lanes]
            ).abs().max().item()
    scale = logits["plain"][..., lanes].abs().max().item()
    check(bool(torch.isfinite(logits["kernels"][..., lanes]).all())
          and bool(torch.isfinite(step_logits[..., lanes]).all()),
          "jamba prefill or decode logits not finite")
    check(diff <= PREFILL_LOGIT_RTOL * scale,
          f"jamba prefill logits on K7, K8 and the pass vs their plain "
          f"versions: max |d| {diff} of max |logit| {scale}")
    print(f"[serve-hybrid] one prefill's last logits, K7 + K8 + pass vs "
          f"their plain versions: max |d| {diff:.4g} of max |logit| "
          f"{scale:.4g} (bound {PREFILL_LOGIT_RTOL} x); the next decode "
          f"step's logits finite", flush=True)
    del hyb_params, logits, cache, step_logits
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the last three families: MLA, the VLM prefix, enc-dec -------------
    from repro_torch.tree import leaves_with_paths, tree_map

    def serve_prompts(vocab: int) -> list:
        """The [serve] request set over ``vocab``: three prompts sharing a
        512-token prefix, one of them twice, and four unrelated ones."""
        prng = np.random.RandomState(0)
        prefix = prng.randint(0, vocab, size=SERVE_PREFIX)
        prompts = [np.concatenate([prefix, prng.randint(
            0, vocab, size=SERVE_PROMPT - SERVE_PREFIX)]) for _ in range(3)]
        prompts.append(prompts[2].copy())
        return prompts + [prng.randint(0, vocab, size=SERVE_PROMPT)
                          for _ in range(SERVE_REQUESTS - len(prompts))]

    def serve_run(tag: str, model, params, prompts, kw: dict, must):
        """One engine over ``prompts`` with every launch counter at 0 just
        before it: tokens checked (all requests, ``SERVE_NEW`` each, in the
        vocabulary) and a paged pool conserved; prints its prefill ms a
        request, decode ms a tick, tokens/s and peak memory.  Returns the
        engine, its tokens, the launch counts and the prefill count."""
        eng = ServeEngine(model, params, n_slots=SERVE_SLOTS,
                          max_seq=SERVE_MAX_SEQ, **kw)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid, prompt, SERVE_NEW))
        spent = {"prefill": [], "decode": []}
        for part in spent:            # both calls end in a host read
            def timed(*a, _fn=getattr(eng.executor, part), _t=spent[part]):
                t = time.perf_counter()
                out = _fn(*a)
                _t.append((time.perf_counter() - t) * 1e3)
                return out
            setattr(eng.executor, part, timed)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run(strict=True)
        wall = time.perf_counter() - t0
        counts = path_counts(tag, must)
        vocab = model.cfg.vocab
        tokens = {c.rid: c.tokens for c in done}
        check(sorted(tokens) == list(range(len(prompts))) and all(
            len(t) == SERVE_NEW and all(0 <= x < vocab for x in t)
            for t in tokens.values()), f"{tag}: tokens {tokens}")
        st = eng.stats()
        if eng.paged_kv:
            eng.pool.check_conservation()
            check(st["cow_copies"] > 0 and st["pages_shared"] > 0,
                  f"{tag}: no page was shared or forked: {st}")
            check(eng.pool.n_free == eng.pool.n_pages,
                  f"{tag}: pages still held after the run: {st}")
        n_tok = sum(len(t) for t in tokens.values())
        pre, dec = spent["prefill"], spent["decode"]
        print(f"[{tag.split()[0]}] {' '.join(tag.split()[1:])}: "
              f"{len(prompts)} requests x {SERVE_PROMPT} prompt tokens, "
              f"{SERVE_NEW} new each, {SERVE_SLOTS} slots, max_seq "
              f"{SERVE_MAX_SEQ}, bf16: {n_tok} tokens in {wall:.2f} s "
              f"({n_tok / wall:.1f} tok/s); prefill ms per request "
              f"{[round(x, 1) for x in pre]}; decode ms per tick median "
              f"{sorted(dec)[len(dec) // 2]:.2f} (min {min(dec):.2f}, max "
              f"{max(dec):.2f}, {len(dec)} ticks); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"launches {counts}; stats {st} ({smi})", flush=True)
        return eng, tokens, counts, len(pre)

    # ---- [serve-mla] deepseek-v2-236b served on the card --------------------
    # published widths (128 heads, q_lora 1536, kv_lora 512, qk 128 + 64, v
    # 128, 160 routed experts top-6 and 2 shared, vocab 102400), depth cut
    # to MLA_LAYERS of 60 (or one fewer where the card's free memory cannot
    # hold the weights, one MoE layer drawn beside them, and the bf16 cast of
    # a MoE layer's experts), parameters made on the card from seed 0; the
    # [serve] request set through the dense engine — the latent cache is not
    # paged, and the paged engine refuses it as the JAX package's does.  MLA
    # is torch products (no K7: its head dims are none K7 is built for); the
    # MoE layers serve in ep_mode="gspmd", as the JAX launcher does
    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated() / 2**30
    free_bytes = torch.cuda.mem_get_info()[0]
    cfg_mla = get_config(MLA_ARCH)
    mo = cfg_mla.moe
    moe_layer = mo.num_experts * 3 * cfg_mla.d_model * mo.d_ff_expert
    mla_layers = MLA_LAYERS
    while True:
        n_mla = sum(p.numel() for p in leaves(build_model(
            cfg_mla.replace(n_layers=mla_layers)).init(0, device="meta")))
        # the float32 weights and one MoE layer drawn beside them (init
        # copies a layer into its slot), which outweighs serving's bf16
        # cast of one layer's experts, and 3 GiB for activations and caches
        need = 4 * (n_mla + moe_layer) + (3 << 30)
        if need <= free_bytes or mla_layers == 2:
            break
        mla_layers -= 1
    check(need <= free_bytes, f"serve-mla: {need / 2**30:.1f} GiB needed at "
          f"{mla_layers} layers, {free_bytes / 2**30:.1f} free")
    cut = ("" if mla_layers == MLA_LAYERS else
           f" (cut from x{MLA_LAYERS}: {free_bytes / 2**30:.1f} GiB free)")
    cfg_mla = cfg_mla.replace(n_layers=mla_layers)
    mla_model = build_model(cfg_mla)
    n_moe_mla = sum(sp.ffn == "moe" for sp in mla_model.plan)
    t0 = time.perf_counter()
    mla_params = mla_model.init(0, device="cuda")
    torch.cuda.synchronize()
    check(sum(p.numel() for p in leaves(mla_params)) == n_mla,
          "serve-mla: parameter count")
    m_ = cfg_mla.mla
    print(f"[plan] {cfg_mla.name} x{mla_layers} of 60 layers{cut} d"
          f"{cfg_mla.d_model} (MLA {cfg_mla.n_heads} heads, q_lora "
          f"{m_.q_lora}, kv_lora {m_.kv_lora}, qk {m_.qk_nope}+{m_.qk_rope}, "
          f"v {m_.v_head}; 1 dense FFN {mo.d_ff_first_dense}, {n_moe_mla} MoE "
          f"of {mo.num_experts} experts top-{mo.top_k} + {mo.n_shared} "
          f"shared): {n_mla} float32 parameters ({n_mla * 4 / 2**30:.1f} "
          f"GiB) initialized on the card from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s ({held_before:.2f} GiB held "
          f"before, {free_bytes / 2**30:.1f} GiB free)", flush=True)
    try:
        ServeEngine(mla_model, mla_params, n_slots=SERVE_SLOTS,
                    max_seq=SERVE_MAX_SEQ, paged_kv=True,
                    page_tokens=SERVE_PAGE)
        refused = ""
    except ValueError as err:
        refused = str(err)
    check("MLA/SSM caches stay dense" in refused,
          f"serve-mla: the paged engine was not refused: {refused!r}")
    mla_prompts = serve_prompts(cfg_mla.vocab)
    eng, _, counts, _ = serve_run("serve-mla dense", mla_model, mla_params,
                                  mla_prompts, {}, ())
    check(counts["flash_attention"] == 0,
          f"serve-mla: K7 launched {counts['flash_attention']} times")
    latent = sum(t.numel() * t.element_size() for path, t in
                 leaves_with_paths(eng.executor.cache)
                 if path[-1] in ("c_kv", "k_rope"))
    per_token = latent // (SERVE_SLOTS * SERVE_MAX_SEQ * mla_layers)
    check(per_token == (m_.kv_lora + m_.qk_rope) * 2,
          f"serve-mla: {per_token} cache bytes a token a layer")
    gqa_token = 2 * cfg_serve.n_kv_heads * cfg_serve.head_dim * 2
    print(f"[serve-mla] the paged engine refused ({refused}); the latent "
          f"cache holds {per_token} bytes a token a layer in bf16 ((kv_lora "
          f"{m_.kv_lora} + qk_rope {m_.qk_rope}) x 2), against "
          f"{cfg_serve.name}'s {gqa_token} (2 x {cfg_serve.n_kv_heads} x "
          f"{cfg_serve.head_dim} x 2)", flush=True)
    del eng
    gc.collect()
    # fault 5's trace: the MoE combine's bf16 index_add adds with atomics
    # on the card, in whatever order they land.  At this layer's shape (a
    # prompt's tokens, top-6 of 160 experts, d 5120): that operator twice
    # on the same inputs, the fixed-order combine (models/moe.py::
    # combine_sorted) twice, and one MoE layer's "gspmd" forward twice
    stack = mla_params["stack"]
    moe_blk = ([blk["moe"] for blk in stack["prefix"] if "moe" in blk]
               + [tree_map(lambda t: t[0], stack["scan"][j]["moe"])
                  for j in sorted(stack["scan"])
                  if "moe" in stack["scan"][j]])[0]
    T_, k_, d_ = SERVE_PROMPT, mo.top_k, cfg_mla.d_model
    eidx = torch.topk(torch.rand((T_, mo.num_experts), generator=gen,
                                 device=dev), k_, dim=-1).indices
    order = torch.argsort(eidx.reshape(-1), stable=True)
    vals = torch.randn((T_ * k_, d_), generator=gen, device=dev).to(
        torch.bfloat16)
    old = [torch.zeros((T_, d_), dtype=torch.bfloat16, device=dev)
           .index_add(0, order // k_, vals) for _ in range(2)]
    new = [moe_lib.combine_sorted(vals, order, k_) for _ in range(2)]
    h = torch.randn((1, T_, d_), generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        outs = [moe_lib.moe_apply(moe_blk, h, cfg_mla, ep_mode="gspmd")[0]
                for _ in range(2)]
    old_same = torch.equal(old[0], old[1])
    old_diff = (old[0].float() - old[1].float()).abs().max().item()
    check(torch.equal(new[0], new[1]),
          "serve-mla: the fixed-order combine differs between two calls")
    check(torch.equal(outs[0], outs[1]),
          "serve-mla: one MoE layer's gspmd forward differs between two "
          "calls on the same inputs")
    print(f"[serve-mla] fault 5: the bf16 index_add combine ({T_} tokens x "
          f"top-{k_}, d {d_}) twice on the same inputs: equal "
          f"{old_same} (max |d| {old_diff:.4g}); the fixed-order combine "
          f"twice: equal True; one MoE layer's gspmd forward twice: equal "
          f"True ({smi})", flush=True)
    del eidx, order, vals, old, new, h, outs, moe_blk
    # one prefill's last logits against the forward's over the same prompt,
    # each made twice
    tok = torch.as_tensor(mla_prompts[0], dtype=torch.int64, device=dev)[None]
    with torch.no_grad():
        pre_logits, cache = mla_model.prefill(
            mla_params, {"tokens": tok}, mla_model.init_cache(1, SERVE_MAX_SEQ))
        step_logits, _ = mla_model.decode_step(
            mla_params, cache, pre_logits[:, -1].argmax(-1, keepdim=True))
        fwd_logits, _ = mla_model.forward(mla_params, {"tokens": tok})
        pre_again, _ = mla_model.prefill(
            mla_params, {"tokens": tok}, mla_model.init_cache(1, SERVE_MAX_SEQ))
        fwd_again, _ = mla_model.forward(mla_params, {"tokens": tok})
    pre_same = torch.equal(pre_logits, pre_again)
    fwd_same = torch.equal(fwd_logits, fwd_again)
    del pre_again, fwd_again
    lanes = slice(0, cfg_mla.vocab)
    diff = (pre_logits[:, -1, lanes] - fwd_logits[:, -1, lanes]
            ).abs().max().item()
    scale = fwd_logits[:, -1, lanes].abs().max().item()
    check(bool(torch.isfinite(pre_logits[..., lanes]).all())
          and bool(torch.isfinite(step_logits[..., lanes]).all()),
          "serve-mla: prefill or decode logits not finite")
    check(diff <= PREFILL_LOGIT_RTOL * scale,
          f"serve-mla: prefill logits vs forward's: max |d| {diff} of max "
          f"|logit| {scale}")
    print(f"[serve-mla] one prefill's last logits vs the forward's over the "
          f"same prompt: max |d| {diff:.4g} of max |logit| {scale:.4g} "
          f"({100 * diff / scale:.3g} %; bound {PREFILL_LOGIT_RTOL} x); two "
          f"prefills equal bit for bit {pre_same}, two forwards {fwd_same}; "
          f"the next decode step's logits finite ({smi})", flush=True)
    del mla_params, pre_logits, step_logits, fwd_logits, cache, mla_model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [serve-vlm] internvl2-1b served on the card -------------------------
    # all 24 layers at published widths (d 896, GQA 14/2, head_dim 64); the
    # [serve] request set through the dense and the paged + COW engine
    # (prompt tokens only, as the JAX engine feeds them), K7 once an
    # attention layer a prefill; then one prefill with 256 seeded patch
    # embeddings (the frontend stub) on K7 against the same on its plain
    # version
    cfg_vlm = get_config(VLM_ARCH)
    vlm_model = build_model(cfg_vlm)
    t0 = time.perf_counter()
    vlm_params = vlm_model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_vlm = sum(p.numel() for p in leaves(vlm_params))
    print(f"[plan] {cfg_vlm.name} x{cfg_vlm.n_layers} layers d"
          f"{cfg_vlm.d_model} (GQA {cfg_vlm.n_heads}/{cfg_vlm.n_kv_heads}, "
          f"head_dim {cfg_vlm.head_dim}, a {cfg_vlm.vlm_prefix}-position "
          f"patch prefix): {n_vlm} float32 parameters "
          f"({n_vlm * 4 / 2**30:.1f} GiB) initialized on the card from seed "
          f"0 in {time.perf_counter() - t0:.1f} s", flush=True)
    vlm_prompts = serve_prompts(cfg_vlm.vocab)
    vlm_out = {}
    for mode, kw in (("dense", {}),
                     ("paged+cow", dict(paged_kv=True, page_tokens=SERVE_PAGE,
                                        prefix_share=True))):
        eng, vlm_out[mode], counts, n_prefill = serve_run(
            f"serve-vlm {mode}", vlm_model, vlm_params, vlm_prompts, kw,
            ("flash_attention",))
        check(counts["flash_attention"] == cfg_vlm.n_layers * n_prefill,
              f"serve-vlm {mode}: K7 launched {counts['flash_attention']} "
              f"times, want {cfg_vlm.n_layers} x {n_prefill} prefills")
        check(k7.COUNTER.by_variant == {
            k7.VARIANTS[torch.bfloat16]: counts["flash_attention"]},
              f"serve-vlm {mode}: K7 variants {k7.COUNTER.by_variant}")
        del eng
        gc.collect()
    check(vlm_out["dense"] == vlm_out["paged+cow"],
          "serve-vlm: dense and paged+COW greedy tokens differ")
    print("[serve-vlm] dense and paged+COW greedy tokens equal bit for bit",
          flush=True)
    batch = {"tokens": torch.as_tensor(vlm_prompts[0], dtype=torch.int64,
                                       device=dev)[None],
             "patches": torch.randn((1, cfg_vlm.vlm_prefix, cfg_vlm.d_model),
                                    generator=gen, device=dev)}
    logits = {}
    for name, fn in (("K7", k7.flash_attention),
                     ("plain", k7.flash_attention_plain)):
        attn_mod.flash_attention = fn
        try:
            logits[name], _ = vlm_model.prefill(
                vlm_params, batch, vlm_model.init_cache(1, SERVE_MAX_SEQ))
        finally:
            attn_mod.flash_attention = k7.flash_attention
    lanes = slice(0, cfg_vlm.vocab)
    diff = (logits["K7"][..., lanes] - logits["plain"][..., lanes]
            ).abs().max().item()
    scale = logits["plain"][..., lanes].abs().max().item()
    check(bool(torch.isfinite(logits["K7"][..., lanes]).all()),
          "serve-vlm: patch-prefix prefill logits not finite")
    check(diff <= PREFILL_LOGIT_RTOL * scale,
          f"serve-vlm: patch-prefix prefill logits on K7 vs its plain "
          f"version: max |d| {diff} of max |logit| {scale}")
    print(f"[serve-vlm] one prefill with {cfg_vlm.vlm_prefix} patch "
          f"embeddings and {SERVE_PROMPT - cfg_vlm.vlm_prefix} tokens, last "
          f"logits on K7 vs its plain version: max |d| {diff:.4g} of max "
          f"|logit| {scale:.4g} (bound {PREFILL_LOGIT_RTOL} x)", flush=True)
    del vlm_params, logits, batch, vlm_model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [encdec] whisper-base on the card -----------------------------------
    # 6 + 6 layers at published widths (d 512, 8 heads of 64, vocab 51865
    # padded to 51968), parameters from seed 0; a batch of 4 rows of 1500
    # seeded frame embeddings (the conv frontend stub), a 128-token decoder
    # prompt, then 32 greedy decode steps.  The prefill runs K7 18 times:
    # the encoder's self-attention (non-causal, 1500 x 1500), then a layer's
    # causal self-attention (128 x 128) and cross-attention (non-causal,
    # 128 x 1500); decode reads the memoized cross k/v.  The engine refuses
    # the family (it has no frames to give a prefill), as the JAX package's
    # cannot serve it
    enc_model = build_model(cfg_enc)
    t0 = time.perf_counter()
    enc_params = enc_model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_enc = sum(p.numel() for p in leaves(enc_params))
    print(f"[plan] {cfg_enc.name} {cfg_enc.enc_layers} + {cfg_enc.n_layers} "
          f"layers d{cfg_enc.d_model} ({cfg_enc.n_heads} heads of "
          f"{cfg_enc.head_dim}, vocab {cfg_enc.vocab} padded to "
          f"{cfg_enc.vocab_padded}): {n_enc} float32 parameters "
          f"({n_enc * 4 / 2**30:.2f} GiB) initialized on the card from seed "
          f"0 in {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        ServeEngine(enc_model, enc_params, n_slots=SERVE_SLOTS,
                    max_seq=SERVE_MAX_SEQ)
        refused = ""
    except ValueError as err:
        refused = str(err)
    check("encoder-decoder" in refused,
          f"encdec: the engine did not refuse the family: {refused!r}")
    frames = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg_enc.d_model),
                         generator=gen, device=dev)
    prompt = torch.randint(0, cfg_enc.vocab, (ENCDEC_BATCH, ENCDEC_PROMPT),
                           generator=gen, device=dev)
    enc_seq = ENCDEC_PROMPT + ENCDEC_NEW
    calls: dict = {}

    def tallied(q, k, v, **kw):
        key = (q.shape[2], k.shape[2], kw["causal"])
        calls[key] = calls.get(key, 0) + 1
        return k7.flash_attention(q, k, v, **kw)

    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn_mod.flash_attention = tallied
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = enc_model.prefill(
                enc_params, {"tokens": prompt, "frames": frames},
                enc_model.init_cache(ENCDEC_BATCH, enc_seq,
                                     enc_len=ENCDEC_FRAMES))
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        nxt.cpu()
        pre_ms = (time.perf_counter() - t0) * 1e3
    finally:
        attn_mod.flash_attention = k7.flash_attention
    generated, step_logits, dec_ms = [nxt], [], []
    for _ in range(ENCDEC_NEW):
        t0 = time.perf_counter()
        with torch.no_grad():
            out, cache = enc_model.decode_step(enc_params, cache,
                                               generated[-1])
        generated.append(out[:, -1].argmax(-1, keepdim=True))
        generated[-1].cpu()
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        step_logits.append(out[:, -1])
    counts = path_counts("encdec prefill + decode", ("flash_attention",))
    enc_peak = torch.cuda.max_memory_allocated() / 2**30
    L_e, L_d = cfg_enc.enc_layers, cfg_enc.n_layers
    want_calls = {(ENCDEC_FRAMES, ENCDEC_FRAMES, False): L_e,
                  (ENCDEC_PROMPT, ENCDEC_PROMPT, True): L_d,
                  (ENCDEC_PROMPT, ENCDEC_FRAMES, False): L_d}
    check(calls == want_calls and counts["flash_attention"] == L_e + 2 * L_d,
          f"encdec: K7 calls {calls}, launches {counts['flash_attention']}; "
          f"want {want_calls}")
    check(k7.COUNTER.by_variant == {
        k7.VARIANTS[torch.bfloat16]: counts["flash_attention"]},
          f"encdec: K7 variants {k7.COUNTER.by_variant}")
    encdec_launches = {"flash_attention_cross": calls[
        (ENCDEC_PROMPT, ENCDEC_FRAMES, False)]}
    toks = torch.cat(generated, 1)                 # (B, 1 + ENCDEC_NEW)
    n_tok = ENCDEC_BATCH * ENCDEC_NEW
    print(f"[encdec] {ENCDEC_BATCH} rows x {ENCDEC_FRAMES} frames and "
          f"{ENCDEC_PROMPT} prompt tokens, {ENCDEC_NEW} greedy steps, bf16: "
          f"prefill {pre_ms:.1f} ms; decode ms per step median "
          f"{sorted(dec_ms)[len(dec_ms) // 2]:.2f} (min {min(dec_ms):.2f}, "
          f"max {max(dec_ms):.2f}); {n_tok} tokens in "
          f"{(pre_ms + sum(dec_ms)) / 1e3:.2f} s "
          f"({n_tok / (pre_ms + sum(dec_ms)) * 1e3:.1f} tok/s); peak memory "
          f"{enc_peak:.2f} GiB; K7 calls {calls} ({smi})", flush=True)
    lanes = slice(0, cfg_enc.vocab)
    check(bool(((toks >= 0) & (toks < cfg_enc.vocab)).all()),
          f"encdec: tokens outside the vocabulary: {toks.tolist()}")
    # the prefill on K7 against the same prefill on its plain version
    attn_mod.flash_attention = k7.flash_attention_plain
    try:
        with torch.no_grad():
            plain_logits, _ = enc_model.prefill(
                enc_params, {"tokens": prompt, "frames": frames},
                enc_model.init_cache(ENCDEC_BATCH, enc_seq,
                                     enc_len=ENCDEC_FRAMES))
    finally:
        attn_mod.flash_attention = k7.flash_attention
    diff = (logits[..., lanes] - plain_logits[..., lanes]).abs().max().item()
    scale = plain_logits[..., lanes].abs().max().item()
    check(bool(torch.isfinite(logits[..., lanes]).all()),
          "encdec: prefill logits not finite")
    check(diff <= PREFILL_LOGIT_RTOL * scale,
          f"encdec: prefill logits on K7 vs its plain version: max |d| "
          f"{diff} of max |logit| {scale}")
    # every decode step's logits against the forward over the prompt and
    # the generated tokens (the forward's attention is full_attention)
    with torch.no_grad():
        fwd, _ = enc_model.forward(enc_params, {
            "tokens": torch.cat([prompt, toks[:, :ENCDEC_NEW]], 1),
            "frames": frames})
    dec = torch.stack(step_logits, 1)[..., lanes]
    ref_ = fwd[:, ENCDEC_PROMPT:, lanes]
    dec_diff = (dec - ref_).abs().max().item()
    dec_scale = ref_.abs().max().item()
    check(bool(torch.isfinite(dec).all()), "encdec: decode logits not finite")
    check(dec_diff <= PREFILL_LOGIT_RTOL * dec_scale,
          f"encdec: decode logits vs forward's: max |d| {dec_diff} of max "
          f"|logit| {dec_scale}")
    print(f"[encdec] the prefill's last logits on K7 vs its plain version: "
          f"max |d| {diff:.4g} of max |logit| {scale:.4g}; the {ENCDEC_NEW} "
          f"decode steps' logits vs the forward over the prompt and the "
          f"generated tokens: max |d| {dec_diff:.4g} of max |logit| "
          f"{dec_scale:.4g} (bound {PREFILL_LOGIT_RTOL} x); the engine "
          f"refused the family ({refused})", flush=True)
    del enc_params, logits, plain_logits, cache, fwd, dec, ref_, \
        step_logits, frames, enc_model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [examples] examples_torch/ on the card -----------------------------
    examples_phase(torch, smi, K, path_counts)

    # ---- [dryrun] the full sweep's records ---------------------------------
    collect_dryrun(dry_proc, dry_log, dry_out, dry_t0, get_config)
    shutil.rmtree(dry_dir, ignore_errors=True)

    # ---- 3. the record ------------------------------------------------------
    replaces = {
        "accumulate": ("K1", "src/repro/kernels/accumulate.py:84"),
        "ring_accumulate": ("K2", "src/repro/kernels/intrinsic.py:90"),
        "ring_accumulate_device": ("K2", "src/repro/kernels/intrinsic.py:90"),
        "ring_accumulate_guarded": ("K2",
                                    "src/repro/kernels/intrinsic.py:90"),
        "ring_put": ("K3", "src/repro/kernels/rma_put.py:47"),
        "ring_put_device": ("K3", "src/repro/kernels/rma_put.py:47"),
        "ring_put_guarded": ("K3", "src/repro/kernels/rma_put.py:47"),
        "ring_put_host": ("K3", "src/repro/kernels/rma_put.py:47"),
        "ring_put_page": ("K3", "src/repro/kernels/rma_put.py:47"),
        "put_wait": ("K3", "src/repro/kernels/rma_put.py:47"),
        "put_signal": ("K4", "src/repro/kernels/ordered_put_signal.py:72"),
        "put_signal_doorbell": ("K4",
                                "src/repro/kernels/ordered_put_signal.py:72"),
        "ring_all_reduce": ("K5", "src/repro/kernels/ring_allreduce.py:108"),
        "accumulate_signal": ("K6",
                              "src/repro/kernels/ordered_put_signal.py:144"),
        "flash_attention": ("K7", "src/repro/kernels/flash_attention.py:84"),
        "flash_attention_cross": ("K7",
                                  "src/repro/kernels/flash_attention.py:84"),
        "ssd_intra_chunk": ("K8", "src/repro/kernels/ssd_scan.py:62"),
        "ssd_pass": ("K8 glue", "src/repro/kernels/ops.py:24"),
        "ssd_intra_chunk_n16": ("K8", "src/repro/kernels/ssd_scan.py:62"),
        "ssd_pass_n16": ("K8 glue", "src/repro/kernels/ops.py:24"),
    }
    sources = {"accumulate": "accumulate.cu", "ring_accumulate": "intrinsic.cu",
               "ring_accumulate_device": "intrinsic.cu",
               "ring_accumulate_guarded": "intrinsic.cu",
               "ring_put": "rma_put.cu", "ring_put_device": "rma_put.cu",
               "ring_put_guarded": "rma_put.cu",
               "ring_put_host": "rma_put.cu", "ring_put_page": "rma_put.cu",
               "put_wait": "rma_put.cu", "put_signal": "put_signal.cu",
               "put_signal_doorbell": "put_signal.cu",
               "ring_all_reduce": "ring_allreduce.cu",
               "accumulate_signal": "put_signal.cu",
               "flash_attention": "flash_attention.cu",
               "flash_attention_cross": "flash_attention.cu",
               "ssd_intra_chunk": "ssd_scan.cu", "ssd_pass": "ssd_pass.cu",
               "ssd_intra_chunk_n16": "ssd_scan.cu",
               "ssd_pass_n16": "ssd_pass.cu"}
    # a K2/K3 row counts the launches of its variant: static host offsets,
    # a displacement from device memory, or the handle guard
    variant_of = {"ring_put": ("ring_put", "static"),
                  "ring_put_device": ("ring_put", "device"),
                  "ring_put_guarded": ("ring_put", "guarded"),
                  "ring_put_host": ("ring_put", "guarded-host"),
                  "ring_accumulate": ("ring_accumulate", "static"),
                  "ring_accumulate_device": ("ring_accumulate", "device"),
                  "ring_accumulate_guarded": ("ring_accumulate", "guarded")}
    rows = []
    for name in replaces:
        r = record[name]
        tag, where = replaces[name]
        # the [serve-disagg] rows count that path's launches alone: K4's
        # doorbells, K3's guarded page moves (and the stale read); the N 16
        # rows the [serve-hybrid] paged engine's; the cross row [encdec]'s
        # cross-attention calls
        path_launches = {**disagg_launches, **hybrid_launches,
                         **encdec_launches}
        count = (path_launches[name] if name in path_launches
                 else variant_launches.get(variant_of[name], 0)
                 if name in variant_of else launches[name])
        check(count > 0, f"{name}: no launch on any path")
        rows.append({
            "name": f"{tag} {name}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name]}",
            "replaces": where, "launches": count,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{key: r[key] for key in ("call_ms", "variant", "tflops",
                                       "vs_library", "prefill_views_ms",
                                       "past_l2", "design", "tbps_of_2x",
                                       "first_ms", "library_first_ms",
                                       "floor_ms", "floor_serial_ms",
                                       "pair_ms", "fig12_ms", "read_ms",
                                       "read_library_ms", "link", "launch",
                                       "sweep_best", "latency_ns",
                                       "tier_seq_ms", "index_copy_ms",
                                       "copy_ms", "path_ms")
               if key in r}})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
