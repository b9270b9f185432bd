"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--layers 32]

Phases (any failure exits non-zero; no phase's exception is caught):

1. the card's name and power limit (``nvidia-smi``);
2. build every hand-written kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together), print the ``-Xptxas -v``
   register / shared-memory summary, and show with ``cuobjdump -sass``
   that ``hete_matmul`` holds wgmma (``HGMMA``), TMA loads (``UTMALDG``)
   and TMA stores (``UTMASTG``), and ``ssd_chunk`` tensor-core products
   (``HMMA``);
3. the first main path: OPT-6.7B at full width (d 4096, 32 heads, FFN 16384,
   vocab 50272, fp32; ``--layers`` of 32, random weights from a seed)
   served by ``LLM(paged=True, backend=HeteGenBackend(...))`` with
   ``submit`` + ``drain``: four greedy requests with ``chunk_tokens`` set
   so the prefill kernel sees ``kv_offset > 0`` — once with fp32 weights
   on the wire and fp32 pages, once with ``wstream="q8"`` and int8 pages.
   Kernel launch counters are zeroed just before and read just after each
   run, the q8 run's ``q8_matmul`` calls also tallied by (M, K, N) and
   both runs' paged attention calls by (B, S, each row's kv end); neither
   matmul kernel may launch on the HeteGen split.  The fp
   run's prefill logits are held against the port's ``ResidentBackend``
   on the card.  Both runs are traced (``trace=``, the tracer attached
   from the backend's construction on): each run's Chrome trace
   (``smoke_out/trace_cell3_<wire>.json``) must validate, its overlap
   report (I/O-hidden fraction, stream utilization, critical path per
   phase) is logged, each stream's busy seconds in the trace must agree
   with the engines' ``StreamStats`` within ``BUSY_TOL``, and the stream
   speeds the trace measures are logged with the alpha they refit beside
   the planned one.  From the fp run's trace, ``H100_HOST``'s host and
   link fields are fitted (``fit_host_spec``: host GEMM spans at decode
   and at the prefill chunks, pin and transfer spans, a timed pageable
   copy of 256 MB, the machine's memory) and logged with the host's CPU
   and the alphas cell 3 would plan with them;
3g. trace-driven recalibration: OPT-6.7B at full width and
   ``RECAL_LAYERS`` layers through ``LLM(paged=True,
   backend=HeteGenBackend(recalibrate=0.02, recalibrate_every=2))``,
   four requests of ``RECAL_NEW`` new tokens, over ``H100_HOST`` with
   ``link_bw`` ``RECAL_LINK_FACTOR`` times too high: the decode plan must
   be rebuilt at least once and its alpha move toward the crossing of the
   run's measured speeds; each decode step's alpha and the decode tok/s
   before the first and after the last re-plan are logged;
3i. speculative decoding on the main path: OPT-6.7B (``--layers``, fp32,
   phase 3's host weights) served by ``LLM(paged=True, backend=
   HeteGenBackend(wstream="fp"))`` over fp32 pages, four greedy requests
   whose ``SPEC_PROMPT``-token prompts repeat a random ``SPEC_RUN``-token
   run, ``SPEC_NEW`` new tokens each, once with ``spec=SpecConfig(
   NgramDrafter(), k=SPEC_K)`` and once without, over one backend, both
   traced.  Tokens must be identical, but for a mismatch at a position
   where the plain run's top-two logit gap is under ``LOGIT_TOL`` of its
   largest |logit| (logged; compared up to there).  Logged for each run:
   tok/s and serve s, busy s per stream track (``pin:verify`` among
   them), the overlap report per phase (``verify`` among them), the
   planned and refit alpha per phase, ``SpecStats`` and the acceptance
   rate, and ``paged_prefill_attention`` launches by (B, S, kv ends);
   the speculative run must launch it at verify shapes (S of 2 to
   ``SPEC_K`` + 1) and the plain run ``paged_decode_attention``;
3b. resident one-shot generation of Mistral-NeMo-12B at full width and
   full depth (40 layers), bf16, random weights made on the card from a
   seed: ``LLM(cfg, params).generate`` of four 512-token prompts, 16 new
   tokens each, on the stacked cache — once bf16, once
   ``kv_dtype="int8"``.  The counters must show exactly one
   flash-attention launch per layer, one flash-decode launch per layer
   and decode step, two RMSNorm launches per layer plus the final norm
   per forward, one ``gated_matmul`` launch (the gate and up products,
   SiLU) per layer and forward, by (rows, width) 40 at (2048, 5120) and
   600 at (4, 5120), and no plain dense attention.  The whole model's prefill
   logits are held against ``ResidentBackend`` on a dense backend cache.
   A reduced Mistral runs on the card (kernels) and on the CPU (plain
   versions): greedy tokens identical in fp32; in bf16, with a bf16 and
   an int8 cache, prefill and decode logits within ``BF16_MODEL_TOL`` of
   the largest |logit| and the same argmax wherever the CPU's top two
   logits stand further apart than twice that;
3c. offloaded one-shot generation of OPT-6.7B (``--layers``, fp32) through
   ``LLM(cfg, backend=HeteGenBackend(...)).generate``: four 64-token
   prompts, 8 new tokens, over the dense backend cache (one
   flash-attention launch per layer, seven flash-decode launches per
   layer).  Its dense-cache prefill logits are held against
   ``ResidentBackend`` (checked in phase 3, while the weights are on the
   card); no matmul kernel launches;
3f. resident one-shot generation of OPT-6.7B (``--layers``, fp32), phase
   3's weights while they are on the card: ``LLM(cfg, params).generate``
   of 3c's four 64-token prompts, 8 new tokens each, on the stacked cache.
   Each layer's fc1 (bias, ReLU) runs the ``matmul`` kernel, once per
   layer and forward (32 at (256, 4096), 224 at (4, 4096) with 32
   layers), beside one flash-attention launch per layer and one
   flash-decode launch per layer and decode step.  Its prefill logits
   are held against 3c's HeteGen(fp) logits within ``LOGIT_TOL``;
3d. resident one-shot generation of Mamba2-2.7B at full width and full
   depth (64 layers), bf16, random weights made on the card from a seed:
   ``LLM(cfg, params).generate`` of four 512-token prompts, 16 new tokens
   each.  Every layer's prefill takes the chunked SSD form, so the
   counters must show one ``ssd_chunk`` launch per layer, two RMSNorm
   launches per layer plus the final norm per forward, and no plain scan.
   A reduced Mamba2 runs on the card and on the CPU: greedy tokens
   identical in fp32, bf16 logits within ``SSM_BF16_MODEL_TOL``;
3e. the bf16 paged batcher: Mistral-NeMo-12B (3b's weights, still on the
   card) through ``LLM(cfg, params, paged=True).generate`` of a ragged
   batch (four prompts of 500-512 tokens, 8 new each), bf16 pages then
   int8 pages, with one paged-prefill launch per layer and prefill call
   and one paged-decode launch per layer and decode step, and one
   ``gated_matmul`` launch per layer and forward (over each prompt's rows
   at prefill, the four rows at decode).  A reduced bf16
   Mistral over a paged cache runs on the card and on the CPU: prefill and
   decode logits within ``BF16_MODEL_TOL``;
3h. request-level sampling over the same weights through the paged
   batcher over bf16 pages: four requests of ``SAMPLE_NEW`` new tokens
   (greedy, temperature 0.8, top-k 50, top-p 0.9 with five logprobs,
   each stochastic one seeded) give the same bits of tokens and logprobs
   from two runs and the same tokens submitted in reverse order; then
   ``sample_rows`` on seeded (4, 131072) fp32 card logits keeps the sort
   order and kept set of ``plain_filter`` (float64 on the CPU, written
   apart from the port; but for tokens at a top-p crossing within an
   fp32 sum's rounding, ``crossing_tol``), draws the CPU's Gumbel noise,
   gives the same bits from two calls, passes a chi-square test of
   ``CHI2_DRAWS`` card draws of one row against the plain distribution,
   and is timed per call and in a CUDA graph;
3i-bf16. after 3h, the same weights through the paged batcher over bf16
   pages: four greedy requests built as in 3i, ``SPEC_NEW`` new tokens,
   speculation (k ``SPEC_K``) through ``AsyncLLM(llm=...)`` with its
   ``stream()`` iterators consumed on the main thread (the loop thread
   launches the kernels) against a plain synchronous run: tokens
   identical as in 3i with ``BF16_LOGIT_TOL``; every verify forward
   launches ``paged_prefill_attention`` at its (B, S) and ``gated_matmul``
   at B x S rows, once per layer;
3j. the scan-stacked families at full width, bf16, random weights made
   on the card from a seed: Gemma-2-2B (26 layers, local/global with a
   4096 window, softcaps 50 / 30, head dim 256; four ``GEMMA_PROMPT``-token
   prompts, past the window), MiniCPM3-4B (62 layers, MLA) and
   Zamba2-1.2B (38 Mamba2 layers, the shared block at 7 sites) at full
   depth, Llama-4 Scout at ``SCOUT_LAYERS`` of 48 layers (16 experts and
   a shared one a layer, about 37 GiB; reduced depth), four
   ``FAMILY_PROMPT``-token prompts for the others, ``FAMILY_NEW`` new
   tokens each.  Each runs ``LLM(cfg, params).generate`` one-shot with
   the launches :func:`family_launches` predicts (MLA attends in plain
   PyTorch, so MiniCPM3 launches no attention kernel; a local layer's
   decode takes the counted plain attention) and first tokens equal to
   the prefill logits' argmax; then, but for Zamba2 (the batcher takes
   no hybrid), the same prompts with ragged budgets through
   ``LLM(paged=False)``'s batcher, whose backend must be
   ``ScanResidentBackend``, with the same kernels launched and the same
   first tokens but at a near tie.  A reduced model of each family runs
   on the card and on the CPU first (:func:`check_small_reference`);
3l. the last three assigned architectures at full width, bf16, random
   weights made on the card from a seed, each after a reduced model of it
   on the card and on the CPU (fp32 greedy tokens identical, bf16 logits
   within ``BF16_MODEL_TOL``; fed embeddings through
   :func:`check_small_embeds`): Whisper-small whole (12 + 12 layers, 1500
   frames) through ``Generator.generate`` of ``WHISPER_BATCH`` rows of
   random frame embeddings behind its start-of-transcript prefix,
   ``WHISPER_NEW`` new tokens (:func:`encdec_launches`: non-causal flash
   over the frames and for cross attention, two flash-decode launches a
   decoder layer and step, the bias + GELU ``matmul``); LLaVA-NeXT-
   Mistral-7B whole (32 layers) from ``LLAVA_BATCH`` x ``LLAVA_PATCHES``
   anyres patch embeddings, ``LLAVA_NEW`` new tokens, then offloaded
   through ``HeteGenBackend`` at ``LLAVA_OFFLOAD_LAYERS`` layers in fp32
   (prefill logits against ``ResidentBackend`` within ``LOGIT_TOL``);
   Nemotron-4-340B at ``NEMOTRON_LAYERS`` of 96 layers (head dim 192, a
   GQA group of 12, squared ReLU, LayerNorm; its weights reckoned beside
   the measured memory) one-shot through ``LLM``, then through
   ``LLM(paged=True)`` over bf16 and int8 pages, a reduced Nemotron at
   head dim 192 card against CPU first.  Each with the launches
   predicted and first tokens equal to the prefill logits' argmax;
   prefill s, decode tok/s and peak memory logged;
3k. training, which reaches no kernel (the port's ``forward_train`` runs
   the plain forms, and every kernel wrapper refuses an input that
   requires grad under grad mode: shown on the card).  The kernel counters
   are zeroed before each step below and must read 0 after it.
   (a) every family the port trains at ``reduced()`` size in fp32 (``tiny``
   as it is; OPT, Gemma-2, Mistral-NeMo, MiniCPM3, Llama-4 Scout with its
   Adafactor, Mamba2, Zamba2, Whisper over frames, LLaVA over patch
   embeddings): one ``loss_and_grads`` and one
   ``make_train_step`` step from the same state and batch on the card and
   on the CPU — loss within ``TRAIN_LOSS_TOL`` relative, every leaf's
   gradient present, finite and within ``TRAIN_GRAD_TOL`` of that leaf's
   largest |g| (OPT's key bias, whose exact gradient is 0, within 1e-5 of
   the largest |g| of the tree on both);
   (b) Gemma-2-2B whole at full width (26 layers, d 2304, 8/4 heads of 256,
   FFN 9216, vocab 256000, window 4096, both softcaps, bf16, remat),
   random weights made on the card: ``make_training_data``'s corpus, B 1 x
   ``TRAIN_SEQ`` a microbatch, ``TRAIN_ACCUM`` microbatches, AdamW with
   fp32 moments, ``TRAIN_STEPS`` steps; every loss finite and every param
   leaf changed by step 1; logged: s per step, tokens/s, model FLOP/s as a
   share of ``BF16_FLOPS`` and peak memory beside its reckoning;
   (c) ``tiny`` under ``Trainer`` on the card: 6 steps against 3, a new
   ``Trainer`` resuming from the checkpoint (async), 3 more — final
   params within 1e-6; a bf16 state saved and restored on the card bit for
   bit;
   (d) ``python -m repro_torch.launch.train --arch tiny --steps 40`` as a
   subprocess on the card: its last loss below its first.
   After phase 3 a line ``cell 3 sim`` gives ``core.sim``'s decode
   prediction for OPT-6.7B (32 layers, fp32 wire, batch 4) over the fitted
   ``H100_HOST`` beside the measured tok/s (a log line, not a check);
3m. the sharded path (``repro_torch.distributed``), each part in a process
   of its own (``--part``): (a) an NCCL world of one rank on a (1, 1)
   ("data", "model") mesh: Mistral-NeMo-12B at full width and depth, its
   weights placed by ``param_specs``, through ``make_prefill_step`` (4 x
   512) and ``SHARD_NEW`` ``make_serve_step``s under
   ``ShardingRules.for_mesh``, then with ``NO_RULES`` on the same weights:
   every step's logits the same bits, greedy tokens equal, the kernels
   launched through ``local_map`` exactly as often as unsharded;
   ``compressed_psum_mean`` over NCCL equal to dequantize(quantize(x));
   the decode kernel's log-sum-exp within ``LSE_TOL`` of its plain
   version's, -inf on the same rows; (b) ``launch/dryrun.run_cell`` with
   ``device="cuda"`` on rank 0 of a fake 256-rank world (collectives move
   no data) for ``SHARD_CELLS`` at ``decode_32k``: argument bytes equal to
   the analytic params plus cache, the measured peak beside the analytic
   total, FLOPs, bytes and collective wire bytes a device, the step's time;
4. every kernel against its plain PyTorch version on the same card
   inputs at the main path's shapes (these launches come after the
   counters were read, so they do not count), with CUDA-event times of kernel,
   plain version and (where one exists) a single PyTorch library call,
   beside the least time the card could take (bytes over 3.35 TB/s or
   FLOPs over the peak for the dtype — 67 TFLOP/s fp32, 989 TFLOP/s bf16;
   for ``q8_matmul`` and fp32 flash attention the least work at fp32
   accuracy, three bf16 products at 989 or three TF32 products at 495
   TFLOP/s, or the fp32 FLOPs at 67, whichever is faster — whichever of
   bytes and FLOPs is larger); the paged kernels in fp32 at a long-context
   shape and at phase 3's two most frequent shapes of each run, and in
   bf16 at 3e's shapes, within the ``ref.paged_*_limit`` bounds (the fp32
   prefill limit shown to reject q and k rounded to TF32; two calls of
   either kernel must give the same bits); ``q8_matmul`` at every (M, K,
   N) that phase 3's q8 run launched it (tallied there, each with its own
   launches), within ``ref.q8_matmul_limit`` (shown to reject the plain
   version over x rounded to bf16 and over x kept to 16 significant bits),
   two calls giving the same bits, beside ``_weight_int8pack_mm``;
   ``paged_prefill_attention`` at the two most frequent verify shapes of
   3i (fp32 pages) and the most frequent of 3i-bf16 (bf16 pages), within
   ``ref.paged_prefill_attention_limit``;
4b. the same for the dense-cache kernels (flash-decode, flash attention,
   RMSNorm) at the shapes of 3b and 3c, held element by element within
   the ``ref.*_limit`` bounds (each attention limit shown to reject an
   off-by-one mask, the bf16 flash limit scores rounded to bf16
   before the softmax, the fp32 one q and k rounded to TF32; two
   flash-decode calls and two flash-attention calls must give the same
   bits);
   a bf16 RMSNorm output must also be bit-equal to
   the plain version but for at most ``ref.RMSNORM_UNEQUAL_MAX`` of its
   elements, a check shown to reject squares rounded to bf16, x * rsqrt
   rounded to bf16 and a mean over D - 1 (all within one bf16 step, so
   within the limit); the library yardsticks are
   ``F.scaled_dot_product_attention`` and ``F.rms_norm``.  A ragged
   ``kv_len`` [512, 1100, 2048, 3001] at T = 4096, in both cache layouts,
   is checked and timed too, but no main path runs that shape, so it is
   logged and left out of the ``kernels`` line;
4c. the SSD intra-chunk kernel and RMSNorm (with 4b's checks) at 3d's
   shapes, the SSD kernel also at the reduced model's,
   held element by element within ``ref.ssd_chunk_limit`` (shown to
   reject a y that drops each row's own term and, in every row of a
   chunk, a y rounded to bf16 and a y over a bf16 G; two calls must give
   the same bits); no single PyTorch
   call computes it, so it has no library time; the reduced shape is
   logged and left out of the ``kernels`` line;
4d. ``matmul`` at 3f's shapes (fp32, bias, ReLU) and ``gated_matmul`` at
   3b's and 3e's (bf16, SiLU), each within ``ref.matmul_limit`` /
   ``ref.gated_matmul_limit`` (shown to reject a sum missing its last K
   block and a result without its bias, or the activation on the up
   product, and in fp32 the products of operands rounded to TF32; two
   calls must give the same bits), timed
   beside the plain version, ``torch.matmul`` of the same product alone
   (``product_ms``) and, for ``matmul``, the library call
   ``torch._addmm_activation`` (bias, product and ReLU or GELU in one
   cuBLASLt call; PyTorch has no single call for the gated function, so
   its ``library_ms`` is null); one shape off the main path each (and
   the gated MLP at Nemotron-4's K 18432, its accumulators unfolded),
   logged only.  Each bf16 entry's name and ``design`` key name the route of
   ``csrc/hete_matmul.cu`` it took (:func:`matmul_design`);
4j. every shape 3j's tally recorded for flash attention, flash-decode,
   ``gated_matmul`` and RMSNorm (Gemma-2's head dim 256 with window and
   softcap, Scout's GQA group of 5 and its qk-norms, Zamba2's shared
   block at head dim 64, MLA's latent norms, the SiLU and GELU MLP
   widths), and ``ssd_chunk`` at Zamba2's shape, against their plain
   versions with 4b's, 4c's and 4d's checks; each limit shown to reject
   keys outside the window, scores without their softcap and, at decode,
   64 values lost mid-sequence.  A softcap's q is widened
   ``SOFTCAP_QSCALE`` times so that the cap bites; its decode entry is
   held on the unshaped cache and, with a hot last key (its softmax
   share logged), against an off-by-one mask.  The softcapped entries'
   library call is ``flex_attention`` under ``torch.compile``;
4l. every shape 3l's one-shot runs tallied (:data:`ARCH_KEYS`): flash
   attention without a causal mask (Whisper's encoder over 1500 frames,
   its cross attention from the prompt; the limit shown to reject the
   last key tile dropped and a causal mask) and with it (LLaVA's 2880
   patches, Nemotron at head dim 192), flash-decode (Whisper's self and
   cross caches, LLaVA's, Nemotron's), bf16 ``matmul`` with bias + GELU
   and with the squared ReLU (its library call ``torch.matmul`` and the
   activation), LLaVA's ``gated_matmul`` and RMSNorm, and the two most
   frequent paged prefill and decode shapes of Nemotron's bf16 and int8
   page runs, with 4b's and 4d's checks; bf16 flash at head dim 96 (no
   main path) logged only;
5. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

Every kernel entry of phase 4 carries two times for the kernel and for
the library call: ``ms`` (``library_ms``), the median of five windows of
20 calls issued back to back, each under CUDA events, which is the
host's issue time wherever that exceeds the device's; and ``device_ms``
(``library_device_ms``), 20 calls captured in one CUDA graph and
replayed under events, the device's time alone (null, with the reason in
``device_ms_null``, where a call cannot be captured).

Exits non-zero without a result when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.core.hw import H100_HOST  # noqa: E402
from repro_torch.data.pipeline import make_training_data  # noqa: E402
from repro_torch.core.policy import build_policy  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import decode_attention as k_dense  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import hete_matmul as k_mm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as k_decode  # noqa: E402
from repro_torch.kernels import paged_prefill as k_prefill  # noqa: E402
from repro_torch.kernels import q8_matmul as k_q8  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as k_rms  # noqa: E402
from repro_torch.kernels import ssd_chunk as k_ssd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import sampling as smp  # noqa: E402
from repro_torch.serving.api import LLM, AsyncLLM, GenRequest  # noqa: E402
from repro_torch.serving.backends import (  # noqa: E402
    HeteGenBackend, ResidentBackend, ScanResidentBackend, enumerate_linears)
from repro_torch.serving.engine import Generator  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.serving.scheduler import PREFILLING  # noqa: E402
from repro_torch.serving.speculative import (NgramDrafter,  # noqa: E402
                                             SpecConfig)
from repro_torch.telemetry import (Tracer, measured_speeds,  # noqa: E402
                                   recalibrate_alpha, validate_chrome_trace)
from repro_torch.telemetry.overlap import stream_of  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM data sheet, fp32 without TC
BF16_FLOPS = 989e12                # H100 SXM data sheet, dense bf16 TC
TF32_FLOPS = 495e12                # H100 SXM data sheet, dense TF32 TC
# The least work that reaches fp32 accuracy on this card: three bf16 (q8:
# int8 weights exact in bf16, x as three bf16 terms) or three TF32 (fp32
# attention, 3xTF32) tensor-core products per product, or one fp32 FMA on
# the CUDA cores, whichever is faster
Q8_PEAK = max(BF16_FLOPS / 3, FP32_FLOPS)
F32_ATTN_PEAK = max(TF32_FLOPS / 3, FP32_FLOPS)
PAGE_SIZE = 16
MAX_NEW = 8                        # new tokens per request
CHUNK = 32                         # chunk_tokens of the chunked prefill
SEED = 0
LOGIT_TOL = 2e-3                   # relative to the logits' max |value|
BF16_LOGIT_TOL = 2e-2              # two bf16 steps (2^-7) of the max |logit|
# reduced bf16 model, card against CPU, relative to the largest |logit|:
# about three times the plain bf16 model's own distance from fp32 on the
# same weights (0.7-1.0% with a bf16 or an int8 cache), which
# check_small_reference prints beside it
BF16_MODEL_TOL = 4e-2
# the same for a reduced Mamba2, whose plain bf16 model lies closer to
# fp32 (0.61% of the largest |logit| at prefill, 0.47% at decode): about
# three times that, so a card path computing in lower precision shows
SSM_BF16_MODEL_TOL = 2e-2
ONESHOT_PROMPT = 512               # 3b: prompt tokens per row
ONESHOT_NEW = 16                   # 3b: new tokens per row
OFFLOAD_PROMPT = 64                # 3c: prompt tokens per row
OFFLOAD_NEW = 8                    # 3c: new tokens per row
MAMBA_PROMPT = 512                 # 3d: prompt tokens per row (4 chunks)
MAMBA_NEW = 16                     # 3d: new tokens per row
PAGED_PROMPTS = (500, 504, 508, 512)   # 3e: ragged prompt lengths
PAGED_NEW = 8                      # 3e: new tokens per row
RECAL_LAYERS = 8                   # 3g: OPT-6.7B layers
RECAL_NEW = 16                     # 3g: new tokens per request
RECAL_LINK_FACTOR = 8.0            # 3g: how far H100_HOST's link_bw is off
SAMPLE_NEW = 8                     # 3h: new tokens per request
SAMPLE_PROMPTS = (40, 44, 48, 52)  # 3h: prompt lengths
BUSY_TOL = 0.05                    # trace busy s against StreamStats
SPEC_PROMPT = 48                   # 3i: prompt tokens per request
SPEC_RUN = 12                      # 3i: the random run each prompt repeats
SPEC_NEW = 16                      # 3i: new tokens per request
SPEC_K = 4                         # 3i: draft tokens per verify step
CHI2_DRAWS = 1 << 16               # 3h: card draws for the chi-square
FAMILY_PROMPT = 512                # 3j: prompt tokens per row
GEMMA_PROMPT = 4608                # 3j: Gemma-2's, past its 4096 window
FAMILY_NEW = 16                    # 3j: new tokens per row
SCOUT_LAYERS = 8                   # 3j: Llama-4 Scout's layers (of 48)
SOFTCAP_QSCALE = 4.0               # 4j: q widened so that a softcap bites
FULL_QSCALE = 4.0                  # 4l: q widened over 1500 frames (below)
LONG_DECODE = 1024                 # 4l: a hot last key from this many keys
# 3l: Whisper's start-of-transcript prefix (<|startoftranscript|> <|en|>
# <|transcribe|> <|notimestamps|> in its multilingual vocabulary)
WHISPER_PREFIX = (50258, 50259, 50359, 50363)
WHISPER_BATCH = 4                  # 3l: rows of 1500 random frames
WHISPER_NEW = 32                   # 3l: new tokens per row
LLAVA_BATCH = 2                    # 3l: images
LLAVA_PATCHES = 2880               # 3l: anyres, a 576-patch base + 4 tiles
LLAVA_NEW = 16                     # 3l: new tokens per image
LLAVA_OFFLOAD_LAYERS = 8           # 3l: the offloaded run's layers (of 32)
LLAVA_OFFLOAD_PATCHES = 592        # 3l: the offloaded run's prompt
LLAVA_OFFLOAD_NEW = 8              # 3l: the offloaded run's new tokens
NEMOTRON_LAYERS = 4                # 3l: Nemotron-4-340B's layers (of 96)
NEMOTRON_PROMPT = 512              # 3l: prompt tokens per row
NEMOTRON_NEW = 16                  # 3l: new tokens per row
TRAIN_FAMILIES = ("tiny", "opt-125m", "gemma2-2b", "mistral-nemo-12b",
                  "minicpm3-4b", "llama4-scout-17b-16e", "mamba2-2.7b",
                  "zamba2-1.2b", "whisper-small",
                  "llava-next-mistral-7b")   # 3k(a): reduced, card vs CPU
TRAIN_SMALL_SEQ = 48               # 3k(a): past the reduced window of 32
TRAIN_LOSS_TOL = 1e-5              # 3k(a): relative
TRAIN_GRAD_TOL = 1e-4              # 3k(a): of each leaf's largest |g|
TRAIN_SEQ = 4096                   # 3k(b): tokens a microbatch (train_4k)
TRAIN_ACCUM = 2                    # 3k(b): microbatches a step
TRAIN_STEPS = 3                    # 3k(b): optimizer steps
TRAIN_LR = 1e-3                    # 3k(b): moves every bf16 weight at step 1
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def timed(phase: str, fn, *args):
    """``fn(*args)``, logging the phase's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, windows: int = 5) -> float:
    """Milliseconds per call: the median over ``windows`` windows of
    ``iters`` calls issued back to back, each window timed with CUDA
    events, after two warm-up calls.  Where the host takes longer to issue
    a call than the device takes to run it, this is the host's time per
    call; the median keeps one window's host stall out of it (single
    windows of 20 RMSNorm calls read 0.0118 and 0.0228 ms at one shape in
    one run)."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[windows // 2]


def device_ms(fn, iters: int = 20):
    """Mean device milliseconds per call with the host's issue time left
    out: ``iters`` calls captured in one CUDA graph, the graph replayed
    under CUDA events.  Returns ``(ms, None)``, or ``(None, reason)`` where
    the call cannot be captured."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:               # not capturable: say why
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {e}".splitlines()[0][:160]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, None


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_sass():
    """The built ``hete_matmul`` library holds wgmma (``HGMMA``), TMA
    loads (``UTMALDG``) and TMA stores (``UTMASTG``): the bf16 kernels
    above 48 rows are the Hopper ones;
    the ``ssd_chunk`` library holds tensor-core products (``HMMA``): its
    bf16 route (``cuobjdump -sass`` of each library, instruction counts
    logged)."""
    cuobjdump = os.path.join(os.path.dirname(kbuild.nvcc()), "cuobjdump")
    counts = {}
    for lib in ("hete_matmul", "ssd_chunk"):
        sass = subprocess.run([cuobjdump, "-sass", str(kbuild.target(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[lib] = {op: sass.count(op)
                       for op in ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")}
        log(f"sass {lib}: {counts[lib]}")
    check(counts["hete_matmul"]["HGMMA"] > 0
          and counts["hete_matmul"]["UTMALDG"] > 0
          and counts["hete_matmul"]["UTMASTG"] > 0,
          "hete_matmul was built without wgmma, TMA loads or TMA stores")
    check(counts["ssd_chunk"]["HMMA"] > 0 or counts["ssd_chunk"]["HGMMA"] > 0,
          "ssd_chunk was built without tensor-core products")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_prompts(vocab: int, seed: int):
    """Four prompts of two chunks each (with the default 32-token chunk):
    the second chunks (18-31 tokens) stay within the prefill plan's 2x
    retune hysteresis of the first, so the plan is built once."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, n)) for n in (50, 56, 60, 63)]


def run_main_path(cfg, host_params, prompts, *, wstream, kv_dtype):
    """One traced serving run through the public entry points; returns
    tokens, the launch counts it caused, its stats and its spans.  The
    tracer is the backend's from construction on, so the spans cover
    every second the engines' stream counters do."""
    t0 = time.perf_counter()
    tracer = Tracer()
    be = HeteGenBackend(cfg, host_params, wstream=wstream, batch=4,
                        tracer=tracer, device="cuda")
    decode_s = time.perf_counter() - t0
    # load: partition (and, for q8, quantize) both phase plans up front,
    # the prefill one at the chunk shape the run admits at; building one
    # phase's engine is what a re-plan of that phase costs
    be.retune(1, phase="prefill", tokens_per_seq=CHUNK)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with LLM(cfg, backend=be, own_backend=True, paged=True,
             page_size=PAGE_SIZE, kv_dtype=kv_dtype, max_slots=4,
             max_len=256, chunk_tokens=CHUNK, wstream=wstream,
             trace=tracer) as llm:
        rids = [llm.submit(p, max_new=MAX_NEW) for p in prompts]
        outs = llm.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        st = llm.stats()
        os.makedirs(OUT_DIR, exist_ok=True)
        doc = llm.write_trace(os.path.join(OUT_DIR,
                                           f"trace_cell3_{wstream}.json"))
        report = llm.overlap_report()
        planned = {ph: pol.alpha for ph, pol in be.policies.items()}
    toks = [outs[r].tokens for r in rids]
    check(all(len(t) == MAX_NEW for t in toks), f"{wstream}: short outputs")
    check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
          f"{wstream}: token out of vocab")
    s = st["stream"]
    log(f"main path wstream={wstream} kv_dtype={kv_dtype or 'float32'}: "
        f"load {load_s:.3f} s (backend and decode engine {decode_s:.3f} s, "
        f"prefill engine {load_s - decode_s:.3f} s), "
        f"{sum(map(len, toks))} tokens in {wall:.3f} s "
        f"({sum(map(len, toks)) / wall:.3f} tok/s, drain "
        f"{st['tokens_per_s']:.3f} tok/s), steps={st['steps']}, "
        f"chunks={st['scheduler']['chunks_planned']}, "
        f"phase_alpha={st['phase_alpha']}, "
        f"busy_s cpu={s.cpu:.3f} pin={s.pin:.3f} trans={s.trans:.3f} "
        f"dev={s.dev:.3f} wall={s.wall:.3f}, "
        f"peak_device_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, launches={launches}")
    spans = tracer.spans()
    report_trace(f"cell 3 {wstream}", doc, report, spans, s, planned)
    return toks, launches, st, spans


# the stream tracks of the overlap report (``pin`` stands for every
# ``pin:<phase>`` track)
STREAMS = ("cpu_gemm", "pin", "transfer", "device", "sample")


def report_trace(run, doc, report, spans, stats, planned):
    """A traced run's Chrome trace must validate; log its overlap report
    (I/O-hidden fraction, stream utilization, critical path per phase),
    hold each stream's busy seconds to the engines' counters, and log the
    stream speeds the trace measures with the alpha it refits, per phase,
    beside the planned one."""
    problems = validate_chrome_trace(doc)
    check(not problems, f"{run}: trace invalid: {problems[:3]}")
    o = report.overall
    util = o.utilization()
    log(f"{run} overlap: {len(doc['traceEvents'])} trace events, window "
        f"{o.wall:.3f} s, io_hidden={o.io_hidden_frac:.4f}, critical "
        f"path {o.critical_path}, utilization "
        + " ".join(f"{k}={util[k]:.4f}" for k in sorted(util)
                   if stream_of(k) in STREAMS))
    by_phase = {}
    for w in report.steps:
        agg = by_phase.setdefault(w.phase, {"n": 0, "wall": 0.0, "io": 0.0,
                                            "hidden": 0.0, "busy": {}})
        agg["n"] += 1
        agg["wall"] += w.wall
        agg["io"] += w.io_busy
        agg["hidden"] += w.io_hidden
        for k, v in w.busy.items():
            agg["busy"][k] = agg["busy"].get(k, 0.0) + v
    for ph, agg in by_phase.items():
        streams = {k: v for k, v in agg["busy"].items()
                   if stream_of(k) in STREAMS}
        crit = max(streams, key=streams.get) if streams else "idle"
        hid = agg["hidden"] / agg["io"] if agg["io"] > 0 else 1.0
        log(f"{run} overlap phase={ph}: {agg['n']} steps, wall "
            f"{agg['wall']:.3f} s, io_hidden={hid:.4f}, critical path "
            f"{crit}, busy s "
            + " ".join(f"{k}={v:.3f}" for k, v in sorted(streams.items())))
    for track, counted in (("cpu_gemm", stats.cpu), ("pin", stats.pin),
                           ("transfer", stats.trans),
                           ("device", stats.dev)):
        # a phase engine's pin thread has a track of its own
        traced = sum(v for k, v in o.busy.items() if stream_of(k) == track)
        log(f"{run} busy s {track}: trace {traced:.4f}, StreamStats "
            f"{counted:.4f}")
        check(abs(traced - counted) <= BUSY_TOL * max(traced, counted),
              f"{run}: {track} busy {traced:.4f} s in the trace, "
              f"{counted:.4f} s in StreamStats")
    for ph, alpha in planned.items():
        sp = measured_speeds(spans, phase=ph)
        fit = recalibrate_alpha(spans, alpha, phase=ph)
        log(f"{run} speeds phase={ph}: v_cpu={sp.v_cpu:.4e} "
            f"v_pin={sp.v_pin:.4e} v_com={sp.v_com:.4e} B/s, wire_ratio="
            f"{sp.wire_ratio:.4f}, planned alpha={alpha:.4f}, refit "
            f"alpha={fit.alpha:.4f}")


def host_description():
    """The host's CPU as ``lscpu`` names it (vendor, family, model, model
    name), ``nproc`` and the memory it reports."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         check=True).stdout
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    cpu = ", ".join(f"{k} {fields[k].strip()}" for k in
                    ("Vendor ID", "CPU family", "Model", "Model name",
                     "Socket(s)", "Thread(s) per core") if k in fields)
    mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return cpu, len(os.sched_getaffinity(0)), mem


def pageable_copy_bw(nbytes=256 << 20, reps=5):
    """Bytes/s of a host-to-card ``copy_`` from pageable memory: the
    median of ``reps`` timed copies of a 256 MB tensor after one warm-up."""
    src = torch.rand(nbytes // 4)
    dst = torch.empty_like(src, device="cuda")
    dst.copy_(src)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return nbytes / sorted(times)[reps // 2]


def fit_host_spec(cfg, spans, smi):
    """``H100_HOST``'s host and link fields from cell 3's traced fp run:
    ``host_mem_bw`` from the host GEMM spans at decode (4 rows),
    ``host_flops`` from those of the prefill chunks in the alpha law's
    units (FLOPs counted as rows per weight byte: the sum of rows x bytes
    over the seconds), ``pin_bw`` and ``link_bw`` from the pin and
    transfer spans, ``link_bw_unpinned`` from a timed pageable copy and
    ``host_mem_bytes`` as the machine reports it.  Logs the fit and the
    decode and prefill alphas cell 3 gets from it beside the current
    spec's."""
    dec = measured_speeds(spans, phase="decode")
    pre = [s for s in spans if s.track == "cpu_gemm"
           and (s.attrs or {}).get("phase") == "prefill"]
    allp = measured_speeds(spans)
    model, nproc, mem = host_description()
    fit = {"host_mem_bw": dec.v_cpu,
           "host_flops": sum(s.attrs["rows"] * s.attrs["bytes"]
                             for s in pre) / sum(s.dur for s in pre),
           "pin_bw": allp.v_pin, "link_bw": allp.v_com,
           "link_bw_unpinned": pageable_copy_bw(),
           "host_mem_bytes": float(mem)}
    log(f"H100_HOST fit on {smi}, host lscpu: {model}; nproc {nproc}: "
        + json.dumps(fit))
    hw = dataclasses.replace(H100_HOST, **fit)
    for wstream in ("fp", "q8"):
        lin = enumerate_linears(cfg, wstream=wstream)
        alphas = {}
        for name, spec in (("current", H100_HOST), ("fitted", hw)):
            alphas[name] = [
                build_policy(lin, spec, batch=4, phase="decode").alpha,
                build_policy(lin, spec, batch=1, phase="prefill",
                             tokens_per_seq=CHUNK).alpha]
        log(f"cell 3 {wstream} alpha decode / prefill: current spec "
            f"{alphas['current'][0]:.4f} / {alphas['current'][1]:.4f}, "
            f"fitted {alphas['fitted'][0]:.4f} / {alphas['fitted'][1]:.4f}")
    return fit


def run_recalibration(cfg, host_params):
    """Phase 3g: cell 3's fp configuration at full width and
    ``RECAL_LAYERS`` layers (``cfg``), four requests of ``CHUNK`` prompt
    tokens and ``RECAL_NEW`` new tokens, with ``recalibrate=0.02,
    recalibrate_every=2`` over ``H100_HOST`` with ``link_bw``
    ``RECAL_LINK_FACTOR`` times too high, so the first decode plan is
    wrong.  It must re-plan, the decode alpha must move toward the
    trace's refit, and the tokens must be complete and in vocab; logs
    each decode forward's alpha and time (its trace span, less the
    re-plan's) and the decode tok/s at the first plan and at the
    last."""
    wrong = dataclasses.replace(H100_HOST,
                                link_bw=H100_HOST.link_bw * RECAL_LINK_FACTOR)
    rng = np.random.default_rng(SEED + 4)
    prompts = [list(rng.integers(0, cfg.vocab_size, CHUNK))
               for _ in range(4)]
    tracer = Tracer()
    be = HeteGenBackend(cfg, host_params, hw=wrong, batch=4, tracer=tracer,
                        recalibrate=0.02, recalibrate_every=2,
                        device="cuda")
    be.retune(4, phase="prefill", tokens_per_seq=CHUNK)
    alpha0 = be.policies["decode"].alpha
    try:
        with LLM(cfg, backend=be, paged=True, page_size=PAGE_SIZE,
                 max_slots=4, max_len=256, chunk_tokens=CHUNK,
                 trace=tracer) as llm:
            rids = [llm.submit(p, max_new=RECAL_NEW) for p in prompts]
            outs = llm.drain()
            torch.cuda.synchronize()
            alpha1 = be.policies["decode"].alpha
            n_replans, fits = be.recalibrations, list(be.fit_alphas)
    finally:
        be.close()
    # each decode forward from the trace: its ``decode`` phase span less
    # the re-plans inside it, at the alpha of the last re-plan before its
    # end, over the rows its ``sample`` span drew
    spans = tracer.spans()
    replans = [s for s in spans if s.track == "replan"]
    forwards = []
    for ph in spans:
        if ph.track != "phase" or ph.name != "decode":
            continue
        inside = [s for s in spans if ph.t0 <= s.t0 and s.t1 <= ph.t1]
        done = [r for r in replans if r.t1 <= ph.t1]
        forwards.append((done[-1].attrs["alpha"] if done else alpha0,
                         sum(s.attrs["rows"] for s in inside
                             if s.track == "sample"),
                         ph.dur - sum(s.dur for s in inside
                                      if s.track == "replan")))
    toks = [outs[r].tokens for r in rids]
    check(all(len(t) == RECAL_NEW for t in toks), "3g: short outputs")
    check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
          "3g: token out of vocab")
    check(n_replans >= 1, "3g: the decode plan was never re-planned")
    # each fit moves at most refine_alpha's probe window (0.08) from the
    # current alpha; where the fits head is the crossing of the measured
    # host and link times, (1 - a) / v_cpu = a * r / min(v_pin, v_com)
    sp = measured_speeds(spans, phase="decode")
    t_cpu, t_com = 1.0 / sp.v_cpu, sp.wire_ratio / min(sp.v_pin, sp.v_com)
    target = t_cpu / (t_cpu + t_com)
    log(f"3g recalibration: alpha planned {alpha0:.4f} (link_bw x"
        f"{RECAL_LINK_FACTOR:g}), fits {[round(a, 4) for a in fits]}, "
        f"{n_replans} re-plans, final {alpha1:.4f}, crossing of the run's "
        f"measured speeds {target:.4f}")
    check(abs(alpha1 - target) < abs(alpha0 - target),
          f"3g: decode alpha {alpha0:.4f} -> {alpha1:.4f} did not move "
          f"toward the refit's crossing {target:.4f}")
    for i, (alpha, rows, secs) in enumerate(forwards):
        log(f"3g decode forward {i + 1}: {rows} rows in {secs:.3f} s at "
            f"alpha {alpha:.4f}")

    def tok_s(alpha):
        sel = [(r, t) for a, r, t in forwards if a == alpha]
        return sum(r for r, _ in sel) / sum(t for _, t in sel), len(sel)
    (r0, n0), (r1, n1) = tok_s(alpha0), tok_s(alpha1)
    log(f"3g decode tok/s: {r0:.4f} over {n0} forwards at the first plan "
        f"(alpha {alpha0:.4f}), {r1:.4f} over {n1} at the last (alpha "
        f"{alpha1:.4f})")


def spec_prompts(vocab: int, seed: int):
    """Four prompts of ``SPEC_PROMPT`` tokens, each a random
    ``SPEC_RUN``-token run (a different one per request) repeated."""
    rng = np.random.default_rng(seed)
    runs = [[int(t) for t in rng.integers(0, vocab, SPEC_RUN)]
            for _ in range(4)]
    return [(r * (SPEC_PROMPT // SPEC_RUN + 1))[:SPEC_PROMPT] for r in runs]


def record_logit_gaps(llm):
    """Wrap the facade's batcher so that each sampled logits row of a
    request records ``(rid, token index) -> (top1 - top2) / max |logit|``;
    returns that dict (filled as the run goes)."""
    b = llm._ensure_batcher()
    gaps = {}
    inner = b._sample_slot_rows

    def sample(logits, slots):
        x = logits.float()
        top = torch.topk(x, 2, dim=-1).values
        rel = ((top[:, 0] - top[:, 1]) / x.abs().amax(dim=-1)).tolist()
        for s, g in zip(slots, rel):
            st = b.scheduler.slot_req[s]
            if st is not None and st.status != PREFILLING:
                gaps[(st.rid, len(st.generated))] = g
        return inner(logits, slots)

    b._sample_slot_rows = sample
    return gaps


def compare_greedy(run, base, spec, gaps, tol):
    """Greedy tokens of a speculative run against the plain run's: equal,
    or differing first at a position where the plain run's top-two logit
    gap is under ``tol`` of its largest |logit| (compared up to there).
    Returns the number of tokens compared."""
    compared = 0
    for rid, (b, s) in enumerate(zip(base, spec)):
        check(len(b) == len(s), f"{run}: request {rid} lengths differ")
        i = next((j for j, (x, y) in enumerate(zip(b, s)) if x != y), None)
        if i is None:
            compared += len(b)
            continue
        g = gaps[(rid, i)]
        log(f"{run}: request {rid} differs first at token {i} ({b[i]} "
            f"plain, {s[i]} speculative); the plain run's top-two gap there "
            f"is {g:.3e} of max |logit| (limit {tol:g})")
        check(g < tol, f"{run}: request {rid} differs at token {i} where "
              f"the top-two gap is {g:.3e} of max |logit|, above {tol:g}")
        compared += i
    return compared


def verify_shapes(tally):
    """The (B, S, kv ends) keys of a paged-prefill tally whose S is a
    verify run's (2 to ``SPEC_K`` + 1)."""
    return {k: n for k, n in tally.items() if 2 <= k[1] <= SPEC_K + 1}


def run_speculative(cfg, host_params):
    """Phase 3i: returns the speculative run's ``paged_prefill_attention``
    calls at verify shapes, by (B, S, kv ends)."""
    prompts = spec_prompts(cfg.vocab_size, SEED + 5)
    t0 = time.perf_counter()
    be = HeteGenBackend(cfg, host_params, wstream="fp", batch=4,
                        device="cuda")
    be.retune(1, phase="prefill", tokens_per_seq=CHUNK)
    log(f"3i load: {time.perf_counter() - t0:.3f} s")
    paged = ("paged_prefill_attention", "paged_decode_attention")
    runs = {}
    try:
        for label, spec in (("plain", None),
                            ("spec", SpecConfig(NgramDrafter(), k=SPEC_K))):
            run = f"3i {label}"
            tracer = Tracer()
            llm = LLM(cfg, backend=be, paged=True, page_size=PAGE_SIZE,
                      max_slots=4, max_len=256, chunk_tokens=CHUNK,
                      wstream="fp", spec=spec, trace=tracer)
            gaps = record_logit_gaps(llm)
            torch.cuda.synchronize()
            be.reset_stats()
            ops.reset_launch_counts()

            def serve():
                t0 = time.perf_counter()
                rids = [llm.submit(p, max_new=SPEC_NEW) for p in prompts]
                outs = llm.drain()
                torch.cuda.synchronize()
                return [outs[r].tokens for r in rids], \
                    time.perf_counter() - t0

            (toks, wall), tally = tally_rows(
                serve, paged, {name: paged_key for name in paged})
            launches = ops.launch_counts()
            st = llm.stats()
            os.makedirs(OUT_DIR, exist_ok=True)
            doc = llm.write_trace(os.path.join(OUT_DIR,
                                               f"trace_3i_{label}.json"))
            report = llm.overlap_report()
            spans = tracer.spans()
            llm.close()
            check(all(len(t) == SPEC_NEW for t in toks),
                  f"{run}: short outputs")
            check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
                  f"{run}: token out of vocab")
            ran = {sp.name for sp in spans if sp.track == "phase"}
            planned = {ph: pol.alpha for ph, pol in be.policies.items()
                       if ph in ran}
            s = st["stream"]
            n_tok = sum(map(len, toks))
            spec_st = {k: v for k, v in st.get("spec", {}).items()
                       if k != "per_request"}
            log(f"{run}: {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.4f} "
                f"tok/s), steps={st['steps']}, chunks="
                f"{st['scheduler']['chunks_planned']}, phase_alpha="
                f"{st['phase_alpha']}, phase_batch={st['phase_batch']}, "
                f"busy_s cpu={s.cpu:.3f} pin={s.pin:.3f} "
                f"trans={s.trans:.3f} dev={s.dev:.3f}, spec={spec_st}, "
                f"launches={launches}")
            log(f"{run} busy s by track: " + " ".join(
                f"{k}={v:.3f}" for k, v in sorted(report.overall.busy.items())
                if stream_of(k) in STREAMS))
            for name in paged:
                log(f"{run}: {name} launches by (B, S, kv ends) "
                    f"{tally[name]}")
                check(sum(tally[name].values()) == launches[name],
                      f"{run}: {name} calls by shape do not add up")
            check(launches["q8_matmul"] == launches["matmul"]
                  == launches["gated_matmul"]
                  == launches["plain_dense_attention"] == 0,
                  f"{run}: a kernel off the fp HeteGen path launched")
            report_trace(run, doc, report, spans, s, planned)
            runs[label] = (toks, gaps, wall, st, launches, tally)
    finally:
        be.close()
    base, gaps, w0, _, l0, _ = runs["plain"]
    spec_toks, _, w1, st, _, tally = runs["spec"]
    verify = verify_shapes(tally["paged_prefill_attention"])
    check(l0["paged_decode_attention"] > 0,
          "3i plain: paged_decode_attention never launched")
    check(sum(verify.values()) > 0, "3i spec: paged_prefill_attention "
          "never launched at a verify shape")
    check("verify" in st["phase_alpha"], "3i spec: no verify plan")
    sp = st["spec"]
    check(sp["drafted"] > 0, "3i spec: nothing drafted")
    n = compare_greedy("3i", base, spec_toks, gaps, LOGIT_TOL)
    log(f"3i: {n} of {sum(map(len, base))} tokens compared equal; tok/s "
        f"plain {sum(map(len, base)) / w0:.4f} ({w0:.3f} s), speculative "
        f"{sum(map(len, spec_toks)) / w1:.4f} ({w1:.3f} s); drafted "
        f"{sp['drafted']} accepted {sp['accepted']} rolled back "
        f"{sp['rolled_back']} (acceptance {sp['acceptance_rate']:.4f}) in "
        f"{sp['steps']} verify steps with drafts; verify shapes {verify}")
    return verify


def compare_prefill_logits(cfg, params, host_params, prompts):
    """The fp backend's prefill logits against ResidentBackend's."""
    toks = torch.tensor([p[:32] for p in prompts], dtype=torch.int32,
                        device="cuda")

    def prefill(be):
        kv = be.init_paged_cache(len(prompts), 64, page_size=PAGE_SIZE)
        for i in range(len(prompts)):
            kv.alloc(i, 32)
        cache = kv.init_cache()
        cache["len"] = torch.zeros((), dtype=torch.int32, device="cuda")
        _, logits = be.prefill({"tokens": toks}, cache)
        return logits

    want = prefill(ResidentBackend(cfg, params, device="cuda"))
    hb = HeteGenBackend(cfg, host_params, batch=4, device="cuda")
    try:
        got = prefill(hb)
    finally:
        hb.close()
    check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"prefill logits HeteGen(fp) vs Resident: max_abs_err={err:.3e} "
        f"max|logit|={scale:.3e} tol={LOGIT_TOL:.0e} relative")
    check(err <= LOGIT_TOL * max(scale, 1.0), "prefill logits disagree")


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_inputs(gen, b, hq, hkv, d, lens, q8, dtype=torch.float32):
    nb = max(-(-n // PAGE_SIZE) for n in lens)
    n_pages = 1 + b * nb
    shape = (n_pages, hkv, PAGE_SIZE, d)
    if q8:
        kp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02
        vs = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02
    else:
        kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        ks = vs = None
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm.reshape(b, nb).to(torch.int32).contiguous()
    return kp, vp, ks, vs, bt


def kv_bytes(lens, hkv, d, q8, el=4):
    per_tok = hkv * (2 * d * (1 if q8 else el) + (8 if q8 else 0))
    return sum(lens) * per_tok


def excess(got, want, limit):
    """Largest |got - want| and its largest ratio to ``limit`` (a number,
    or a per-element tensor of limits)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err / limit).max())


def kernel_entry(name, source, replaces, launches, got, want, limit,
                 kernel_fn, plain_fn, library_fn, nbytes, flops,
                 peak=FP32_FLOPS):
    """Check one kernel's output against its plain version's element by
    element, time both and the library call, and return its ``kernels``
    line entry."""
    err, ratio = excess(got, want, limit)
    check(ratio <= 1.0, f"{name}: max_abs_err {err:.3e}, worst error "
          f"{ratio:.3f} x its limit")
    ms = time_ms(kernel_fn)
    plain_ms = time_ms(plain_fn)
    library_ms = None if library_fn is None else time_ms(library_fn)
    dev_ms, why = device_ms(kernel_fn)
    lib_dev_ms, lib_why = (None, None) if library_fn is None \
        else device_ms(library_fn)
    b_ms, b_by = bound(nbytes, flops, peak)
    lim = f"{limit:.1e}" if isinstance(limit, float) else \
        f"per element, median {float(limit.median()):.2e}"

    def num(x):
        return "none" if x is None else f"{x:.4f}"

    log(f"kernel {name}: max_abs_err={err:.3e} worst err/limit={ratio:.3f} "
        f"(limit {lim}) ms={ms:.4f} device_ms={num(dev_ms)} "
        f"plain_ms={plain_ms:.4f} library_ms={num(library_ms)} "
        f"library_device_ms={num(lib_dev_ms)} "
        f"bound_ms={b_ms:.4f} ({b_by}) launches={launches}")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": library_ms, "library_device_ms": lib_dev_ms}
    if why:
        entry["device_ms_null"] = why
    if lib_why:
        entry["library_device_ms_null"] = lib_why
    return entry


def paged_key(q, k_pages, v_pages, block_tables, lens, *_, **__):
    """(B, S, each row's kv end) of a paged attention call: S is 1 at
    decode (q (B, Hq, D)); a row's kv end is kv_offset + S at prefill and
    kv_len at decode.  Reading ``lens`` waits for the device."""
    s = q.shape[2] if q.dim() == 4 else 1
    shift = s if q.dim() == 4 else 0
    return (q.shape[0], s, tuple(int(n) + shift for n in lens.tolist()))


def top_shapes(tally, n=2):
    """The ``n`` most frequent shapes of a paged tally, ties to the one
    with the most keys."""
    return sorted(tally, key=lambda k: (-tally[k], -sum(k[2])))[:n]


def paged_entry(name, kind, gen, hq, hkv, d, b, s, ends, q8, dtype,
                launches):
    """One paged kernel (``kind`` "prefill" or "decode") on random pages
    and q at B rows of S queries whose kv ends are ``ends``: within its
    ``ref.paged_*_attention_limit``, the same bits from two calls,
    the prefill limit shown to reject q and k rounded to TF32 (fp32
    pages); timed beside its plain version and the bound."""
    kp, vp, ks, vs, bt = paged_inputs(gen, b, hq, hkv, d, list(ends), q8,
                                      dtype)
    kw = dict(k_scale=ks, v_scale=vs)
    el = torch.finfo(dtype).bits // 8
    if kind == "prefill":
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
        lens = torch.tensor([e - s for e in ends], dtype=torch.int32,
                            device="cuda")
        kernel, plain = k_prefill.paged_prefill_attention, \
            ref.paged_prefill_attention
        limit_fn = ref.paged_prefill_attention_limit
        flops = 4 * hq * d * sum(e - s + r + 1 for e in ends
                                 for r in range(s))
        source, replaces = "paged_prefill_attention.cu", \
            "src/repro/kernels/paged_prefill.py:197"
    else:
        q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
        lens = torch.tensor(list(ends), dtype=torch.int32, device="cuda")
        kernel, plain = k_decode.paged_decode_attention, \
            ref.paged_decode_attention
        limit_fn = ref.paged_decode_attention_limit
        flops = 4 * hq * d * sum(ends)
        source, replaces = "paged_decode_attention.cu", \
            "src/repro/kernels/paged_attention.py:160"
    got = kernel(q, kp, vp, bt, lens, **kw)
    check(torch.equal(kernel(q, kp, vp, bt, lens, **kw), got),
          f"{name}: two calls differ")
    want = plain(q, kp, vp, bt, lens, **kw)
    limit = limit_fn(q, kp, vp, bt, lens, want, **kw)
    if kind == "prefill" and dtype == torch.float32 and not q8:
        rejects(plain(tf32(q), tf32(kp), vp, bt, lens), want, limit,
                f"{name}, q and k rounded to TF32")
    nbytes = 2 * q.numel() * el + kv_bytes(list(ends), hkv, d, q8, el) \
        + bt.numel() * 4 + 4 * b
    return kernel_entry(
        name, "src/repro_torch/csrc/" + source, replaces, launches, got,
        want, limit, lambda: kernel(q, kp, vp, bt, lens, **kw),
        lambda: plain(q, kp, vp, bt, lens, **kw), None, nbytes, flops,
        FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS)


def check_kernels(cfg, launches, q8_shapes, paged_shapes):
    """Phase 4: the paged kernels at long-context shapes (fp32 and int8
    pages), at phase 3's two most frequent shapes of each run, and at
    3e's; ``q8_matmul`` at every shape phase 3's q8 run launched it."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    entries = []
    for kind in ("decode", "prefill"):
        name = f"paged_{kind}_attention"
        for q8 in (False, True):
            tag = "_q8" if q8 else ""
            # long context, logged beside the main path's own shapes:
            # decode kv_len up to a few thousand, prefill 4 chunks of 64
            # queries at kv offsets past page edges
            if kind == "decode":
                b, s, ends = 4, 1, (512, 1100, 2048, 3001)
            else:
                b, s, ends = 4, 64, tuple(o + 64 for o in (0, 64, 517, 1500))
            entries.append(paged_entry(
                name + tag, kind, gen, hq, hkv, d, b, s, ends, q8,
                torch.float32, launches[name][q8]))
            tally = paged_shapes[kind][q8]
            for shape in top_shapes(tally):
                b, s, ends = shape
                entries.append(paged_entry(
                    f"{name}{tag}_b{b}_s{s}_kv{'-'.join(map(str, ends))}",
                    kind, gen, hq, hkv, d, b, s, ends, q8, torch.float32,
                    tally[shape]))

    entries += check_paged_bf16(launches)

    # q8 matmul at every (M, K, N) phase 3's q8 run launched it
    for (m, k, n), count in sorted(q8_shapes.items()):
        entries.append(q8_entry(gen, m, k, n, count))
    return entries


def check_verify_shapes(cfg, fp_tally, bf16_tally):
    """``paged_prefill_attention`` at the two most frequent verify shapes
    of 3i (fp32 q and pages, OPT's heads) and the most frequent of
    3i-bf16 (bf16, Mistral's heads), each with its launches."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    entries = []
    mcfg = get_config("mistral-nemo-12b")
    for c, tally, n, dtype, tag in ((cfg, fp_tally, 2, torch.float32, ""),
                                    (mcfg, bf16_tally, 1, torch.bfloat16,
                                     "_bf16")):
        for b, s, ends in top_shapes(tally, n):
            entries.append(paged_entry(
                f"paged_prefill_attention{tag}_verify_b{b}_s{s}_kv"
                f"{'-'.join(map(str, ends))}", "prefill", gen, c.n_heads,
                c.n_kv_heads, c.hd, b, s, ends, False, dtype,
                tally[(b, s, ends)]))
    return entries


def q8_entry(gen, m, k, n, launches):
    """``q8_matmul`` at one main-path shape on random operands (x ~ N(0,
    1), weights ~ N(0, 1) quantized per column): within
    ``ref.q8_matmul_limit``, the limit shown to reject the plain version
    over x rounded to bf16 and over x kept to 16 significant bits (what a
    two-term bf16 split of x carries), the same bits from two calls; timed
    beside the plain version and ``_weight_int8pack_mm``."""
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    qw, sc = (torch.from_numpy(a).cuda() for a in
              k_q8.quantize_weights_np(w.cpu().numpy()))
    del w
    name = f"q8_matmul_m{m}_k{k}_n{n}"
    got = k_q8.q8_matmul(x, qw, sc)
    check(torch.equal(k_q8.q8_matmul(x, qw, sc), got),
          f"{name}: two calls differ")
    want = ref.q8_matmul(x, qw, sc)
    limit = ref.q8_matmul_limit(x, qw, sc, want)
    rejects(ref.q8_matmul(x.to(torch.bfloat16).float(), qw, sc), want,
            limit, f"{name}, x rounded to bf16")
    bits16 = ((x.view(torch.int32) + 0x80) & ~0xFF).view(torch.float32)
    rejects(ref.q8_matmul(bits16, qw, sc), want, limit,
            f"{name}, x kept to 16 significant bits")
    return kernel_entry(
        name, "src/repro_torch/csrc/q8_matmul.cu",
        "src/repro/kernels/q8_matmul.py:85", launches, got, want, limit,
        lambda: k_q8.q8_matmul(x, qw, sc), lambda: ref.q8_matmul(x, qw, sc),
        library_q8(x, qw, sc), m * k * 4 + k * n + n * 4 + m * n * 4,
        2 * m * n * k, Q8_PEAK)


def check_paged_bf16(launches):
    """The paged kernels under a bf16 q at 3e's shapes (Mistral's heads;
    decode over the ragged batch at its last step, prefill of its longest
    prompt), over bf16 pages and over int8 pages, each within its
    per-element limit."""
    cfg = get_config("mistral-nemo-12b")
    gen = torch.Generator(device="cuda").manual_seed(99)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lens = tuple(n + PAGED_NEW - 1 for n in PAGED_PROMPTS)
    s = max(PAGED_PROMPTS)
    entries = []
    for q8 in (False, True):
        tag = "_bf16" + ("_q8" if q8 else "")
        kv = "int8" if q8 else "bf16"
        entries.append(paged_entry(
            "paged_decode_attention" + tag, "decode", gen, hq, hkv, d,
            len(lens), 1, lens, q8, torch.bfloat16,
            launches["paged_decode_attention_3e"][kv]))
        entries.append(paged_entry(
            "paged_prefill_attention" + tag, "prefill", gen, hq, hkv, d, 1,
            s, (s,), q8, torch.bfloat16,
            launches["paged_prefill_attention_3e"][kv]))
    return entries


def library_q8(x, qw, sc):
    """PyTorch's own int8-weight matmul (``_weight_int8pack_mm``: x @ w.T
    * scales with w (N, K) int8) as the yardstick, where this build has
    it for CUDA fp32 activations; None otherwise."""
    op = getattr(torch.ops.aten, "_weight_int8pack_mm", None)
    if op is None:
        return None
    wt = qw.t().contiguous()
    try:
        y = op(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"library q8: _weight_int8pack_mm unavailable here ({e!s:.80})")
        return None
    if not torch.allclose(y, ref.q8_matmul(x, qw, sc), rtol=1e-3, atol=1e-3):
        log("library q8: _weight_int8pack_mm disagrees; not used")
        return None
    return lambda: op(x, wt, sc)


# ---------------------------------------------------------------------------
# phases 3b and 3c: one-shot generation over the dense KV cache
# ---------------------------------------------------------------------------

def expected_oneshot_launches(cfg, new_tokens, *, resident):
    """What the route rule predicts for one rectangular one-shot run: one
    flash-attention launch per layer (the prefill from position 0), one
    flash-decode launch per layer and decode step, for an RMSNorm model
    two norms per layer plus the final one per forward, and, over resident
    weights, one fused MLP first stage per layer and forward
    (:func:`mlp_launches`); the HeteGen split (``resident=False``)
    launches neither matmul kernel."""
    n = {"flash_attention": cfg.n_layers,
         "decode_attention": cfg.n_layers * (new_tokens - 1),
         "plain_dense_attention": 0}
    if cfg.norm_kind == "rmsnorm":
        n["rmsnorm"] = (2 * cfg.n_layers + 1) * new_tokens
    return {**n, **mlp_launches(cfg, new_tokens if resident else 0)}


def mlp_launches(cfg, forwards):
    """One fused MLP first stage per layer and forward: ``gated_matmul``
    for a gated MLP, ``matmul`` otherwise, and none of the other."""
    gated = cfg.mlp_kind.startswith("gated")
    n = cfg.n_layers * forwards
    return {"gated_matmul": n if gated else 0, "matmul": 0 if gated else n}


def check_launches(run, launches, want):
    for name, n in want.items():
        check(launches[name] == n,
              f"{run}: {name} launched {launches[name]} times, want {n}")


def run_oneshot(run, llm_fn, prompts, new_tokens, cfg):
    """One ``LLM.generate`` of a rectangular batch with the counters zeroed
    just before and read just after; returns tokens and launches."""
    llm = llm_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, max_new=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(llm.last_executor == "generator",
          f"{run}: executor {llm.last_executor}, want generator")
    toks = [o.tokens for o in outs]
    check(all(len(t) == new_tokens for t in toks), f"{run}: short outputs")
    check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
          f"{run}: token out of vocab")
    m = llm.last_metrics
    log(f"{run}: {len(prompts)} x {len(prompts[0])} prompt tokens, "
        f"{new_tokens} new each: wall {wall:.3f} s, prefill "
        f"{m['prefill_s']:.4f} s, decode {m['decode_s']:.4f} s "
        f"({m['tokens_per_s']:.3f} tok/s), peak_device_mem="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches={launches}")
    return toks, launches, llm


def check_small_reference(cfg, seed, prompt_len=24, small=None):
    """A reduced model of the same family (``small``, ``reduced(cfg)``
    unless given) on the card (every attention, norm and SSD chunk
    through a kernel) and on the CPU (the plain versions).  In fp32 one-shot generation gives identical greedy
    tokens.  In bf16 (for an attention model with a bf16 and an int8
    stacked cache) prefill logits at every position and one decode step's
    logits agree within ``BF16_MODEL_TOL`` (``SSM_BF16_MODEL_TOL`` for
    Mamba2) of the largest |logit|, with the same argmax wherever the
    CPU's top two logits stand more than twice that apart."""
    small = small or reduced(cfg)                          # fp32
    params = M.init_params(small, seed, device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(0, small.vocab_size, prompt_len))
               for _ in range(3)]
    with LLM(small, params, device="cpu") as llm:
        want = [o.tokens for o in llm.generate(prompts, max_new=8)]
    with LLM(small, M.tree_to(params, "cuda")) as llm:
        got = [o.tokens for o in llm.generate(prompts, max_new=8)]
        check(llm.last_executor == "generator", "small: executor")
    log(f"small reference {small.name}: card tokens == CPU tokens: "
        f"{got == want}")
    check(got == want, f"{small.name}: card tokens differ from the CPU's")

    toks = torch.tensor([list(rng.integers(0, small.vocab_size, prompt_len))
                         for _ in range(8)], dtype=torch.int32)
    # an int8 cache where the family has one (GQA stacks)
    kv_dtypes = (None, "int8") if small.family in ("dense", "vlm") \
        and small.attn_kind == "gqa" else (None,)
    tol = SSM_BF16_MODEL_TOL if small.family == "ssm" else BF16_MODEL_TOL
    for kv_dtype in kv_dtypes:
        bf = dataclasses.replace(small, dtype="bfloat16", kv_dtype=kv_dtype)
        check_small_bf16(f"small bf16 kv={kv_dtype or 'bf16'}", bf, seed,
                         lambda c, p, dev: _prefill_and_step(
                             c, p, toks.to(dev), dev), tol)


def check_small_bf16(run, bf, seed, forward, tol):
    """``forward(cfg, params, device)`` -> (prefill logits, decode-step
    logits) of a bf16 config on the card and on the CPU, held within
    ``tol`` of the largest |logit| (and beside the plain bf16 model's own
    distance from fp32).  For MoE the router's expert choices are held
    first (:func:`moe_flips`), and the rows a near-tie flip excuses are
    left out of the logits' comparison."""
    f32 = dataclasses.replace(bf, dtype="float32")
    p_bf = M.init_params(bf, seed, device="cpu")
    runs = {"card": (bf, M.tree_to(p_bf, "cuda"), "cuda"),
            "cpu": (bf, p_bf, "cpu"),
            "cpu_fp32": (f32, _to_float(p_bf), "cpu")}
    out, routes = {}, {}
    for name, (c, p, dev) in runs.items():
        out[name], routes[name] = record_routes(
            lambda: forward(c, p, dev))
    b, s = out["cpu"][0].shape[:2]
    rows = list(range(b))
    if bf.n_experts:
        excused = moe_flips(run, routes["card"], routes["cpu"], b, s)
        rows = [r for r in rows if r not in excused]
        log(f"{run}: {len(excused)} of {b} rows excused for a router flip "
            f"at a near tie")
        check(len(rows) > 0, f"{run}: every row excused")
    for i, what in enumerate(("prefill logits", "decode-step logits")):
        card, cpu, exact = (out[n][i][rows]
                            for n in ("card", "cpu", "cpu_fp32"))
        scale = float(cpu.abs().max())
        rel = float((card - cpu).abs().max()) / scale
        own = float((cpu - exact).abs().max()) / scale
        top = torch.topk(cpu, 2, dim=-1).values
        stable = (top[..., 0] - top[..., 1]) > 2 * tol * scale
        same = (card.argmax(-1) == cpu.argmax(-1))[stable]
        log(f"{run} {what}: card vs CPU max_abs_err/max|logit|="
            f"{rel:.3e} (tol {tol:.0e}); CPU bf16 vs fp32 "
            f"{own:.3e}; argmax equal at {int(same.sum())} of "
            f"{int(stable.sum())} stable positions")
        check(rel <= tol, f"{run}: {what} disagree")
        check(bool(same.all()) and int(stable.sum()) > 0,
              f"{run}: {what} argmax differs at a stable position")


def record_routes(fn):
    """``fn()`` with each call of the MoE router (``layers.moe_route``)
    recorded on the host, per token: the chosen expert, whether it was
    kept, and the gap between the top two router logits beside their
    largest |value|.  Returns ``fn()``'s result and the calls in order."""
    calls, inner = [], L.moe_route

    def recorded(cfg, p, x, *, capacity):
        out = inner(cfg, p, x, capacity=capacity)
        logits = (x @ p["router"].to(x.dtype)).float()
        top = torch.topk(logits, 2, dim=-1).values
        calls.append({"idx": out[0].reshape(-1).cpu(),
                      "keep": out[3].reshape(-1).cpu(),
                      "gap": (top[..., 0] - top[..., 1]).reshape(-1).cpu(),
                      "scale": logits.abs().amax(-1).reshape(-1).cpu()})
        return out

    L.moe_route = recorded
    try:
        return fn(), calls
    finally:
        L.moe_route = inner


def moe_flips(run, card, cpu, b, s):
    """The rows of a (b, s) batch that a router flip excuses.  The card's
    and the CPU's router calls, in order (the prefill's groups over the
    b * s tokens row after row, then a decode step's b tokens), keep the
    same tokens (the reduced config's capacity drops none) and pick the
    same experts, but for a token whose top two router logits lie within
    ``BF16_LOGIT_TOL`` of their largest |value| on the CPU: a near tie
    that bf16 rounding on the other side may flip.  Its row is excused
    from then on, since every later input of that row differs.  Each
    flip is logged."""
    check(len(card) == len(cpu), f"{run}: {len(card)} router calls on the "
          f"card, {len(cpu)} on the CPU")
    excused = set()
    for i, (c, w) in enumerate(zip(card, cpu)):
        check(torch.equal(c["keep"], w["keep"]),
              f"{run}: router call {i}: capacity drops differ")
        per_row = s if c["idx"].numel() == b * s else 1
        for tok in torch.nonzero(c["idx"] != w["idx"]).flatten().tolist():
            row = tok // per_row
            gap, scale = float(w["gap"][tok]), float(w["scale"][tok])
            log(f"{run}: router call {i} token {tok} (row {row}): expert "
                f"{int(c['idx'][tok])} on the card, {int(w['idx'][tok])} "
                f"on the CPU, top-two gap {gap:.3e} of max|router logit| "
                f"{scale:.3e}")
            if row not in excused:
                check(gap <= BF16_LOGIT_TOL * scale, f"{run}: router call "
                      f"{i} picks another expert away from a near tie")
                excused.add(row)
    return excused


def _to_float(tree):
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    return tree.float()


def _prefill_and_step(cfg, params, toks, device):
    """Prefill logits at every position and the logits of one decode step
    after them (fed each prompt's first token, the same on every side),
    both as fp32 on the CPU."""
    b, s = toks.shape
    cache, logits = M.prefill(cfg, params, {"tokens": toks},
                              M.init_cache(cfg, b, s + 1, device=device),
                              all_logits=True)
    _, step = M.decode_step(cfg, params, toks[:, 0], cache)
    return logits.float().cpu(), step.float().cpu()


def compare_whole_model_logits(cfg, params, prompts):
    """The stacked whole model's prefill logits against ResidentBackend's
    on a dense backend cache, both on the card over the same tensors."""
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    b, s = toks.shape
    _, want = M.prefill(cfg, params, {"tokens": toks},
                        M.init_cache(cfg, b, s, device="cuda"))
    be = ResidentBackend(cfg, params, device="cuda")
    _, got = be.prefill({"tokens": toks}, be.init_cache(b, s))
    check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    log(f"3b prefill logits whole model vs ResidentBackend: "
        f"max_abs_err={err:.3e} max|logit|={scale:.3e} "
        f"tol={BF16_LOGIT_TOL:.0e} relative")
    check(err <= BF16_LOGIT_TOL * max(scale, 1.0), "3b logits disagree")
    return torch.argmax(want, dim=-1).tolist()


def rows_width(x, *_, **__):
    """(rows, width) of an operand: the shape key of :func:`tally_rows`."""
    return x.numel() // x.shape[-1], x.shape[-1]


def tally_rows(fn, names=("rmsnorm",), key=rows_width):
    """Run ``fn()`` with the calls of each ``ops.<name>`` on CUDA tensors
    tallied by shape, ``key(*operands)`` ((rows, width) of the first
    operand by default; ``key`` may also be a dict by name; the model and
    the engine call the ``ops`` entry points, which launch the kernels on
    CUDA tensors), so that each shape gets its own launches; returns
    ``fn()``'s result and ``{name: {shape: calls}}``.  A key takes the
    call's keyword arguments too."""
    tally = {name: {} for name in names}
    inner = {name: getattr(ops, name) for name in names}
    keys = key if isinstance(key, dict) else {name: key for name in names}

    def tallied(name):
        def fn_(x, *a, **kw):
            if x.is_cuda:
                shape = keys[name](x, *a, **kw)
                rows = tally[name]
                rows[shape] = rows.get(shape, 0) + 1
            return inner[name](x, *a, **kw)
        return fn_

    for name in names:
        setattr(ops, name, tallied(name))
    try:
        return fn(), tally
    finally:
        for name in names:
            setattr(ops, name, inner[name])


def run_mistral(seed):
    """Phase 3b: Mistral-NeMo-12B resident at full depth, bf16, one-shot;
    returns the launch counts of the bf16 and int8 runs, and the bf16
    run's RMSNorm launches by row count."""
    cfg = get_config("mistral-nemo-12b")
    log(f"3b model: mistral-nemo-12b at full width and depth, "
        f"{cfg.n_layers} layers, d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} ffn={cfg.d_ff} vocab="
        f"{cfg.vocab_size} dtype={cfg.dtype}")
    check_small_reference(cfg, seed)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"3b init: {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
        f"card")
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(0, cfg.vocab_size, ONESHOT_PROMPT))
               for _ in range(4)]
    first = compare_whole_model_logits(cfg, params, prompts)
    want = expected_oneshot_launches(cfg, ONESHOT_NEW, resident=True)
    counts = {}
    for kv_dtype in (None, "int8"):
        run_cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        run = f"3b mistral kv={kv_dtype or 'bf16'}"
        (toks, launches, llm), tally = tally_rows(
            lambda: run_oneshot(run, lambda: LLM(run_cfg, params), prompts,
                                ONESHOT_NEW, cfg),
            ("rmsnorm", "gated_matmul"))
        llm.close()
        check_launches(run, launches, want)
        for name, rows in tally.items():
            check(sum(rows.values()) == launches[name],
                  f"{run}: {name} calls by shape do not add up to its "
                  f"launches")
        rows = tally["rmsnorm"]
        b = len(prompts)
        want_mm = {(b * ONESHOT_PROMPT, cfg.d_model): cfg.n_layers,
                   (b, cfg.d_model): cfg.n_layers * (ONESHOT_NEW - 1)}
        check(tally["gated_matmul"] == want_mm,
              f"{run}: gated_matmul by shape {tally['gated_matmul']}, want "
              f"{want_mm}")
        log(f"{run}: launches by (rows, width): rmsnorm {dict(rows)}, "
            f"gated_matmul {tally['gated_matmul']}")
        if kv_dtype is None:
            check([t[0] for t in toks] == first,
                  "3b: first tokens differ from the prefill logits' argmax")
        counts[kv_dtype or "bf16"] = launches
        counts[(kv_dtype or "bf16") + "_rmsnorm_rows"] = rows
        counts[(kv_dtype or "bf16") + "_gated_rows"] = tally["gated_matmul"]
    del llm
    counts["3e"] = run_paged_bf16(cfg, params, seed)
    counts["3h"] = timed("3h", run_sampling, cfg, params, seed)
    counts["3i_bf16"] = timed("3i-bf16", run_spec_bf16, cfg, params, seed)
    del params
    torch.cuda.empty_cache()
    return counts


def count_calls(be):
    """Count a backend's prefill and decode calls (the forwards the
    batcher runs), by wrapping the two methods on the instance; the
    caller deletes the two wrappers after the run (each holds the
    backend, so they would keep its weights alive)."""
    calls = {"prefill": 0, "decode": 0}

    def counted(name):
        inner = getattr(be, name)

        def fn(*a, **kw):
            calls[name] += 1
            return inner(*a, **kw)
        return fn

    be.prefill = counted("prefill")
    be.decode = counted("decode")
    return calls


def run_paged_bf16(cfg, params, seed):
    """Phase 3e: the bf16 model through the paged batcher, bf16 pages
    then int8 pages; returns each run's launch counts."""
    rng = np.random.default_rng(seed + 2)
    prompts = [list(rng.integers(0, cfg.vocab_size, n))
               for n in PAGED_PROMPTS]
    out = {}
    for kv_dtype in (None, "int8"):
        run = f"3e mistral paged kv={kv_dtype or 'bf16'}"
        llm = LLM(cfg, params, paged=True, kv_dtype=kv_dtype, max_slots=4,
                  max_len=max(PAGED_PROMPTS) + PAGED_NEW,
                  page_size=PAGE_SIZE)
        calls = count_calls(llm.backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs, tally = tally_rows(
            lambda: llm.generate(prompts, max_new=PAGED_NEW),
            ("gated_matmul",))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        mm_rows = tally["gated_matmul"]
        check(llm.last_executor == "batcher",
              f"{run}: executor {llm.last_executor}, want batcher")
        toks = [o.tokens for o in outs]
        check(all(len(t) == PAGED_NEW for t in toks), f"{run}: short outputs")
        check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
              f"{run}: token out of vocab")
        st = llm.stats()
        log(f"{run}: {len(prompts)} prompts of {PAGED_PROMPTS} tokens, "
            f"{PAGED_NEW} new each: wall {wall:.3f} s "
            f"({sum(map(len, toks)) / wall:.3f} tok/s), steps="
            f"{st['steps']}, forwards {calls}, peak_device_mem="
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches={launches}, gated_matmul by (rows, width) "
            f"{mm_rows}")
        del llm.backend.prefill, llm.backend.decode
        llm.close()
        n_fwd = calls["prefill"] + calls["decode"]
        check_launches(run, launches, {
            "paged_prefill_attention": cfg.n_layers * calls["prefill"],
            "paged_decode_attention": cfg.n_layers * calls["decode"],
            "rmsnorm": (2 * cfg.n_layers + 1) * n_fwd,
            "flash_attention": 0, "decode_attention": 0,
            "plain_dense_attention": 0, **mlp_launches(cfg, n_fwd)})
        check(calls["prefill"] > 0 and calls["decode"] > 0,
              f"{run}: no prefill or no decode forward")
        want_mm = {(n, cfg.d_model): cfg.n_layers for n in PAGED_PROMPTS}
        want_mm[(len(prompts), cfg.d_model)] = cfg.n_layers * calls["decode"]
        check(mm_rows == want_mm, f"{run}: gated_matmul by shape {mm_rows}, "
              f"want {want_mm}")
        out[kv_dtype or "bf16"] = launches
        out[(kv_dtype or "bf16") + "_gated_rows"] = mm_rows
    small = dataclasses.replace(reduced(cfg), dtype="bfloat16")
    toks = torch.tensor([list(rng.integers(0, small.vocab_size, 24))
                         for _ in range(8)], dtype=torch.int32)
    for kv_dtype in (None, "int8"):
        check_small_bf16(f"3e small bf16 paged kv={kv_dtype or 'bf16'}",
                         small, seed,
                         lambda c, p, dev: _paged_prefill_and_step(
                             c, p, toks.to(dev), dev, kv_dtype),
                         BF16_MODEL_TOL)
    return out


def crossing_tol(n_vocab):
    """How far an fp32 prefix sum of ``n_vocab`` probabilities may lie
    from the exact one in any summation order (first order): a token
    whose mass before it lies this close to ``top_p`` may fall on either
    side of the top-p crossing."""
    return (n_vocab - 1) * 2.0 ** -24


def chi2_pvalue(stat, dof):
    """Upper tail of the chi-square distribution (Wilson-Hilferty's cube
    root normal approximation, within about 1e-3 of the exact tail for
    tens of degrees of freedom)."""
    h = 2.0 / (9.0 * dof)
    z = ((stat / dof) ** (1.0 / 3.0) - (1.0 - h)) / math.sqrt(h)
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def plain_filter(logits, params):
    """The sampler's filter written plainly and apart from the port, per
    row in float64 on the CPU: the logits sorted descending with the JAX
    package's tie rule (the higher index first among equal logits), scaled
    by the temperature (floored at 1e-4), a softmax, then top-k and top-p
    by a direct prefix scan: a sorted position survives while fewer than
    k positions came before it (k > 0) and the mass before it is below p;
    position 0 always survives.  Returns the order, the kept mask over
    sorted positions, the kept probabilities renormalized in vocab order,
    and |mass before each sorted position - p|."""
    x = logits.double().cpu().numpy()
    b, v = x.shape
    idx = np.arange(v)
    order = np.empty((b, v), dtype=np.int64)
    keep = np.zeros((b, v), dtype=bool)
    probs = np.zeros((b, v))
    margin = np.empty((b, v))
    for i, p in enumerate(params):
        o = np.lexsort((-idx, -x[i]))        # by -x, ties by -index
        s = x[i, o] / max(p.temperature, 1e-4)
        e = np.exp(s - s[0])
        pr = e / e.sum()
        before = 0.0
        for j in range(v):
            if j and ((p.top_k > 0 and j >= p.top_k) or before >= p.top_p):
                break
            keep[i, j] = True
            before += pr[j]
        margin[i] = np.abs(np.cumsum(pr) - pr - p.top_p)
        kept = np.where(keep[i], pr, 0.0)
        order[i] = o
        probs[i, o] = kept / kept.sum()
    return (torch.from_numpy(order), torch.from_numpy(keep),
            torch.from_numpy(probs), torch.from_numpy(margin))


def check_sampler_on_card(seed):
    """``sample_rows`` on seeded (4, 131072) fp32 card logits (quantized to
    1/16, so rows hold ties): the same sort order and kept set as
    :func:`plain_filter`, except at a top-p crossing within
    ``crossing_tol``; the card's Gumbel noise equal to the CPU's; the
    same bits from two calls; a chi-square test of ``CHI2_DRAWS`` card
    draws of one row against the plain filtered distribution; and its
    time per call and on the device (a CUDA graph of the call on a key
    tensor)."""
    v = 131072
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = (torch.randn((4, v), generator=gen, device="cuda") * 64) \
        .round() / 16
    params = [SamplingParams(kind="temperature", temperature=0.8),
              SamplingParams(kind="topk", top_k=50),
              SamplingParams(kind="topp", top_p=0.9),
              SamplingParams(kind="topp", top_p=0.95, top_k=64,
                             temperature=1.5)]
    packed = smp.pack_sampling(params, device="cuda")
    order, _, keep = smp.filter_sorted(logits, packed)
    p_order, p_keep, probs, margin = plain_filter(logits, params)
    check(torch.equal(order.cpu(), p_order), "3h: card sort order differs "
          "from the plain version's")
    crossings, worst = 0, 0.0
    for i in range(4):
        diff = torch.nonzero(keep[i].cpu() != p_keep[i]).flatten()
        if diff.numel():
            worst = max(worst, float(margin[i, diff].max()))
            check(worst <= crossing_tol(v),
                  f"3h: row {i} kept set differs from the plain "
                  f"version's at sorted "
                  f"positions {diff.tolist()[:8]}")
            crossings += diff.numel()
    log(f"3h sampler (4, {v}) fp32: kept per row "
        f"{keep.sum(-1).tolist()} (plain {p_keep.sum(-1).tolist()}), "
        f"{crossings} tokens apart, each at a top-p crossing (largest "
        f"|mass before - p| {worst:.3e}, limit {crossing_tol(v):.3e})")
    keys = [smp.seed_key(seed + i) for i in range(4)]
    keys_t = smp.key_tensor(keys, "cuda")
    noise = smp.gumbel_noise(keys_t, v).cpu()
    check(torch.equal(smp._mix64_t(keys_t).cpu(),
                      smp._mix64_t(smp.key_tensor(keys)))
          and torch.allclose(noise, smp.gumbel_noise(smp.key_tensor(keys),
                                                     v),
                             rtol=1.2e-7, atol=1e-7),
          "3h: the card's Gumbel noise differs from the CPU's")
    a, ia = smp.sample_rows(logits, keys, packed, top_logprobs=5)
    b, ib = smp.sample_rows(logits, keys, packed, top_logprobs=5)
    check(torch.equal(a, b) and all(torch.equal(ia[k], ib[k]) for k in ia),
          "3h: two sample_rows calls gave different bits")
    kept_vocab = torch.zeros_like(keep).scatter_(-1, order, keep)
    check(bool(kept_vocab.gather(-1, a[:, None].long()).all()),
          "3h: a draw left its kept set")
    row, p = logits[3:4], params[3]
    counts = torch.zeros(v, dtype=torch.int64, device="cuda")
    chunk = 1024
    packed_n = smp.pack_sampling([p] * chunk, device="cuda")
    base = smp.seed_key(seed + 99)
    for c in range(CHI2_DRAWS // chunk):
        ks = [smp.fold_in(base, c * chunk + j) for j in range(chunk)]
        toks = smp.sample_rows(row.expand(chunk, -1), ks, packed_n)
        counts += torch.bincount(toks.long(), minlength=v)
    counts = counts.cpu().double()
    want = probs[3] * CHI2_DRAWS
    check(float(counts[want == 0].sum()) == 0.0,
          "3h: a chi-square draw left the kept set")
    big = want >= 5
    obs = torch.cat([counts[big], counts[~big].sum()[None]])
    exp = torch.cat([want[big], want[~big].sum()[None]])
    if float(exp[-1]) == 0.0:
        obs, exp = obs[:-1], exp[:-1]
    stat = float(((obs - exp) ** 2 / exp).sum())
    dof = obs.numel() - 1
    pval = chi2_pvalue(stat, dof)
    log(f"3h chi-square: {CHI2_DRAWS} card draws of a top-p 0.95 / top-k "
        f"64 row at T 1.5 over {dof + 1} bins: stat {stat:.2f}, "
        f"p={pval:.4f}")
    check(pval > 1e-3, f"3h: card draws do not follow the filtered "
          f"distribution (p={pval:.2e})")
    timing = {}
    for name, fn in (
            ("sample_rows", lambda: smp.sample_rows(logits, keys_t, packed)),
            ("sample_rows_logprobs5", lambda: smp.sample_rows(
                logits, keys_t, packed, top_logprobs=5))):
        ms = time_ms(fn)
        dev, why = device_ms(fn)
        check(dev is not None, f"3h: {name} not capturable: {why}")
        timing[name] = {"ms": ms, "device_ms": dev}
        log(f"3h {name} (4, {v}) fp32: {ms:.4f} ms per call, device "
            f"{dev:.4f} ms (CUDA graph)")
    return timing


def run_sampling(cfg, params, seed):
    """Phase 3h: the bf16 model through the paged batcher over bf16 pages,
    four requests of ``SAMPLE_NEW`` new tokens — greedy, temperature 0.8,
    top-k 50, and top-p 0.9 with five logprobs, every stochastic one
    seeded — twice (the same bits of tokens and logprobs) and in reverse
    order (each request's tokens unchanged); then the sampler's own checks
    and times on the card."""
    rng = np.random.default_rng(seed + 3)
    prompts = [list(rng.integers(0, cfg.vocab_size, n))
               for n in SAMPLE_PROMPTS]
    sps = [SamplingParams(),
           SamplingParams(kind="temperature", temperature=0.8,
                          seed=seed + 11),
           SamplingParams(kind="topk", top_k=50, seed=seed + 12),
           SamplingParams(kind="topp", top_p=0.9, logprobs=5,
                          seed=seed + 13)]

    def serve(order):
        llm = LLM(cfg, params, paged=True, max_slots=4,
                  max_len=max(SAMPLE_PROMPTS) + SAMPLE_NEW,
                  page_size=PAGE_SIZE)
        try:
            t0 = time.perf_counter()
            outs = llm.generate([prompts[i] for i in order],
                                max_new=SAMPLE_NEW,
                                sampling=[sps[i] for i in order])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(llm.last_executor == "batcher",
                  f"3h: executor {llm.last_executor}, want batcher")
        finally:
            llm.close()
        by = dict(zip(order, outs))
        return [by[i] for i in range(len(prompts))], wall

    first, wall = serve([0, 1, 2, 3])
    again, _ = serve([0, 1, 2, 3])
    rev, _ = serve([3, 2, 1, 0])
    toks = [o.tokens for o in first]
    check(all(len(t) == SAMPLE_NEW for t in toks), "3h: short outputs")
    check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
          "3h: token out of vocab")
    check(toks == [o.tokens for o in again]
          and [o.logprobs for o in first] == [o.logprobs for o in again],
          "3h: two runs gave different tokens or logprobs")
    check(toks == [o.tokens for o in rev],
          "3h: a request's tokens changed with the submission order")
    lp = first[3].logprobs
    check(lp is not None and len(lp) == SAMPLE_NEW
          and all(len(e["top"]) == 5 and e["token"] == t
                  and math.isfinite(e["logprob"]) and e["logprob"] <= 1e-6
                  for e, t in zip(lp, toks[3]))
          and all(o.logprobs is None for o in first[:3]),
          "3h: logprob records malformed")
    log(f"3h paged bf16 sampling: {len(prompts)} requests (greedy, T 0.8, "
        f"top-k 50, top-p 0.9 + logprobs 5) of {SAMPLE_PROMPTS} tokens, "
        f"{SAMPLE_NEW} new: wall {wall:.3f} s, tokens {toks}, first "
        f"logprob record {lp[0]}")
    return check_sampler_on_card(seed)


def run_spec_bf16(cfg, params, seed):
    """Phase 3i-bf16: returns the speculative run's
    ``paged_prefill_attention`` calls at verify shapes."""
    prompts = spec_prompts(cfg.vocab_size, seed + 6)
    kw = dict(paged=True, max_slots=4, page_size=PAGE_SIZE,
              max_len=SPEC_PROMPT + SPEC_NEW + 8)
    llm = LLM(cfg, params, **kw)
    gaps = record_logit_gaps(llm)
    try:
        t0 = time.perf_counter()
        rids = [llm.submit(p, max_new=SPEC_NEW) for p in prompts]
        outs = llm.drain()
        torch.cuda.synchronize()
        w0 = time.perf_counter() - t0
    finally:
        llm.close()
    base = [outs[r].tokens for r in rids]
    llm = LLM(cfg, params, spec=SpecConfig(NgramDrafter(), k=SPEC_K), **kw)
    shapes = []
    inner = llm.backend.verify

    def verify(batch, cache):
        shapes.append(tuple(batch["tokens"].shape))
        return inner(batch, cache)

    llm.backend.verify = verify
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    def serve():
        t0 = time.perf_counter()
        with AsyncLLM(llm=llm) as allm:
            its = [allm.stream(p, SPEC_NEW) for p in prompts]
            toks = [list(it) for it in its]      # consumed on this thread
            st = allm.stats()
        torch.cuda.synchronize()
        return toks, st, time.perf_counter() - t0

    try:
        (toks, st, w1), tally = tally_rows(
            serve, ("paged_prefill_attention", "gated_matmul"),
            {"paged_prefill_attention": paged_key,
             "gated_matmul": rows_width})
    finally:
        del llm.backend.verify
        llm.close()
    launches = ops.launch_counts()
    run = "3i-bf16"
    check(all(len(t) == SPEC_NEW for t in toks), f"{run}: short outputs")
    verify_tally = verify_shapes(tally["paged_prefill_attention"])
    sp = st["spec"]
    log(f"{run}: plain {sum(map(len, base)) / w0:.3f} tok/s ({w0:.3f} s), "
        f"speculative through AsyncLLM {sum(map(len, toks)) / w1:.3f} "
        f"tok/s ({w1:.3f} s), executor {st['executor']}; drafted "
        f"{sp['drafted']} accepted {sp['accepted']} rolled back "
        f"{sp['rolled_back']} (acceptance {sp['acceptance_rate']:.4f}); "
        f"verify forwards by (B, S) {shapes}; paged_prefill_attention by "
        f"(B, S, kv ends) {tally['paged_prefill_attention']}; gated_matmul "
        f"by (rows, width) {tally['gated_matmul']}; launches={launches}")
    check(shapes, f"{run}: no verify forward")
    check(launches["plain_dense_attention"] == 0,
          f"{run}: plain dense attention ran")
    for b, s in set(shapes):
        n = shapes.count((b, s))
        got = sum(c for k, c in verify_tally.items() if k[:2] == (b, s))
        check(got >= cfg.n_layers * n,
              f"{run}: {got} paged_prefill_attention launches at (B, S) "
              f"({b}, {s}), want {cfg.n_layers * n}")
        check(tally["gated_matmul"].get((b * s, cfg.d_model), 0)
              >= cfg.n_layers * n,
              f"{run}: gated_matmul did not launch at {b * s} rows")
    compare_greedy(run, base, toks, gaps, BF16_LOGIT_TOL)
    return verify_tally


def _paged_prefill_and_step(cfg, params, toks, device, kv_dtype):
    """Last-position prefill logits and one decode step's (fed each
    prompt's first token) through ResidentBackend over a paged cache,
    both as fp32 on the CPU."""
    be = ResidentBackend(cfg, params, device=device)
    b, s = toks.shape
    kv = be.init_paged_cache(b, s + 1, page_size=PAGE_SIZE,
                             kv_dtype=kv_dtype)
    for i in range(b):
        kv.alloc(i, s + 1)
    cache = kv.init_cache()
    cache["len"] = torch.zeros((), dtype=torch.int32, device=device)
    cache, logits = be.prefill({"tokens": toks}, cache)
    _, step = be.decode(toks[:, 0], cache)
    return logits.float().cpu(), step.float().cpu()


def run_mamba(seed):
    """Phase 3d: Mamba2-2.7B resident at full depth, bf16, one-shot;
    returns the run's launch counts and its RMSNorm launches by rows."""
    cfg = get_config("mamba2-2.7b")
    log(f"3d model: mamba2-2.7b at full width and depth, {cfg.n_layers} "
        f"layers, d={cfg.d_model} d_inner={cfg.d_inner} heads="
        f"{cfg.ssm_heads}x{cfg.ssm_head_dim} state={cfg.ssm_state} "
        f"groups={cfg.ssm_groups} chunk={cfg.ssm_chunk} vocab="
        f"{cfg.vocab_size} dtype={cfg.dtype}")
    check_small_reference(cfg, seed, prompt_len=48)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"3d init: {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
        f"card")
    rng = np.random.default_rng(seed + 3)
    prompts = [list(rng.integers(0, cfg.vocab_size, MAMBA_PROMPT))
               for _ in range(4)]
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    logits = M.prefill(cfg, params, {"tokens": toks},
                       M.init_cache(cfg, len(prompts), MAMBA_PROMPT,
                                    device="cuda"))[1]     # drop the state
    check(bool(torch.isfinite(logits).all()), "3d: non-finite logits")
    first = torch.argmax(logits, dim=-1).tolist()
    (toks, launches, llm), tally = tally_rows(
        lambda: run_oneshot("3d mamba2", lambda: LLM(cfg, params), prompts,
                            MAMBA_NEW, cfg))
    rows = tally["rmsnorm"]
    llm.close()
    check_launches("3d", launches, {
        "ssd_chunk": cfg.n_layers, "plain_ssd_scan": 0,
        "rmsnorm": (2 * cfg.n_layers + 1) * MAMBA_NEW,
        "plain_dense_attention": 0, "flash_attention": 0,
        "decode_attention": 0, "matmul": 0, "gated_matmul": 0})
    # per layer a pre-norm (width d_model) and a gated norm (d_inner):
    # over B x L rows in the prefill, B rows in each decode step; the final
    # norm (d_model) once per forward over each row's last position
    b, steps = len(prompts), MAMBA_NEW - 1
    want_rows = {(b * MAMBA_PROMPT, cfg.d_model): cfg.n_layers,
                 (b * MAMBA_PROMPT, cfg.d_inner): cfg.n_layers,
                 (b, cfg.d_model): 1 + steps * (cfg.n_layers + 1),
                 (b, cfg.d_inner): steps * cfg.n_layers}
    log(f"3d: rmsnorm launches by (rows, width) {dict(rows)}")
    check(rows == want_rows, f"3d: rmsnorm launches by shape {rows}, "
          f"want {want_rows}")
    check([t[0] for t in toks] == first,
          "3d: first tokens differ from the prefill logits' argmax")
    del params, llm
    torch.cuda.empty_cache()
    return {"launches": launches, "rmsnorm_rows": rows}


# ---------------------------------------------------------------------------
# phase 3j: the scan-stacked families through LLM(paged=False)
# ---------------------------------------------------------------------------

def family_launches(cfg, new_tokens):
    """What the route rule predicts for one rectangular one-shot run of a
    3j family: a flash-attention launch per attention layer (the prefill
    from position 0; none for MLA, which attends in plain PyTorch), a
    flash-decode launch per global attention layer and decode step, the
    plain dense attention at each local layer's decode step, an RMSNorm
    launch per norm (the block's two, Gemma-2's two post-norms, the
    qk-norms or MLA's two latent norms; a Mamba2 layer's two) plus the
    final one per forward, and one ``gated_matmul`` per MLP (a dense MLP,
    a shared expert, the hybrid's shared MLP) and forward; Zamba2 adds one
    ``ssd_chunk`` launch per Mamba2 layer and reaches the attention
    kernels at its shared-block sites only."""
    steps = new_tokens - 1
    n = cfg.n_layers
    if cfg.family == "hybrid":
        sites = len(cfg.shared_attn_sites())
        return {"ssd_chunk": n, "plain_ssd_scan": 0,
                "flash_attention": sites, "decode_attention": sites * steps,
                "plain_dense_attention": 0,
                "rmsnorm": (2 * n + 2 * sites + 1) * new_tokens,
                "gated_matmul": sites * new_tokens, "matmul": 0}
    kinds = cfg.layer_kinds()
    local = sum(k == "local" for k in kinds)
    attn = 0 if cfg.attn_kind == "mla" else n
    norms = 2 + 2 * cfg.post_norm + 2 * (cfg.qk_norm
                                         or cfg.attn_kind == "mla")
    mlps = sum(k != "moe" or cfg.shared_expert for k in kinds)
    return {"flash_attention": attn,
            "decode_attention": (attn - local) * steps,
            "plain_dense_attention": local * steps,
            "rmsnorm": (norms * n + 1) * new_tokens,
            "gated_matmul": mlps * new_tokens, "matmul": 0, "ssd_chunk": 0}


def first_tokens_match(run, firsts, logits):
    """Each row's first token against the prefill logits' argmax; a
    mismatch passes only where the top two logits lie within
    ``BF16_LOGIT_TOL`` of the largest |logit| (a near tie another batch
    shape may round the other way), and is logged."""
    want = torch.argmax(logits, dim=-1).tolist()
    top = torch.topk(logits.float(), 2, dim=-1).values
    gap = (top[:, 0] - top[:, 1]).tolist()
    scale = float(logits.float().abs().max())
    for i, (got, w) in enumerate(zip(firsts, want)):
        if got != w:
            log(f"{run}: row {i} first token {got}, prefill argmax {w}, "
                f"top-two gap {gap[i]:.3e} of max|logit| {scale:.3e}")
            check(gap[i] <= BF16_LOGIT_TOL * scale,
                  f"{run}: first token differs from the prefill argmax")


# 3j's shape keys, each a call's whole shape, so that 4j can rebuild it:
# flash (B, Hq, Hkv, S, D, window, softcap), decode (B, Hq, Hkv, T, D,
# softcap), gated_matmul (rows, K, N, activation), rmsnorm (rows, width,
# plus_one); every family's calls carry its ``norm_eps``
FAMILY_KEYS = {
    "flash_attention": lambda q, k, v, **kw: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
        kw.get("window"), kw.get("softcap")),
    "decode_attention": lambda q, k, v, kv_len, **kw: (
        q.shape[0], q.shape[1], k.shape[1], k.shape[2], q.shape[2],
        kw.get("softcap")),
    "gated_matmul": lambda x, wg, wu, **kw: (
        *rows_width(x), wg.shape[1], kw.get("activation", "silu")),
    "rmsnorm": lambda x, w, **kw: (*rows_width(x),
                                   kw.get("plus_one", False)),
}


def run_family(name, layers, prompt_len, seed):
    """One 3j family at full width, bf16, random weights made on the card:
    a reduced model of the family card against CPU
    (:func:`check_small_reference`); ``LLM(cfg, params).generate`` of
    four ``prompt_len``-token prompts, ``FAMILY_NEW`` new tokens each,
    one-shot on the stacked cache, with the launches
    :func:`family_launches` predicts and the first tokens equal to the
    prefill logits' argmax; then, for a family the batcher takes, the same
    prompts with ragged budgets through the dense batcher's
    ``ScanResidentBackend``.  Returns the one-shot run's launches and its
    calls by shape (attention by window and softcap, MLP and norm by
    rows and width; :data:`FAMILY_KEYS`)."""
    full = get_config(name)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    log(f"3j model: {name} at full width, {cfg.n_layers} of "
        f"{full.n_layers} layers, d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} ffn={cfg.d_ff} attn={cfg.attn_kind} "
        f"kinds={sorted(set(cfg.layer_kinds()))} experts={cfg.n_experts} "
        f"window={cfg.window} softcaps={cfg.attn_softcap}/"
        f"{cfg.logit_softcap} vocab={cfg.vocab_size} dtype={cfg.dtype}")
    check_small_reference(cfg, seed, prompt_len=48)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"3j {name} init: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rng = np.random.default_rng(seed + 5)
    prompts = [list(rng.integers(0, cfg.vocab_size, prompt_len))
               for _ in range(4)]
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    _, logits = M.prefill(cfg, params, {"tokens": toks},
                          M.init_cache(cfg, len(prompts),
                                       prompt_len + FAMILY_NEW,
                                       device="cuda"))
    check(bool(torch.isfinite(logits).all()), f"3j {name}: non-finite "
          "logits")
    (out, launches, llm), tally = tally_rows(
        lambda: run_oneshot(f"3j {name}", lambda: LLM(cfg, params), prompts,
                            FAMILY_NEW, cfg), tuple(FAMILY_KEYS),
        FAMILY_KEYS)
    llm.close()
    log(f"3j {name}: calls by shape {tally}")
    check_launches(f"3j {name}", launches, family_launches(cfg, FAMILY_NEW))
    kernels = ["flash_attention", "decode_attention", "gated_matmul",
               "rmsnorm"]
    if cfg.attn_kind == "mla":                 # MLA attends in plain code
        kernels = ["gated_matmul", "rmsnorm"]
    if cfg.family == "hybrid":
        kernels.append("ssd_chunk")
    for k in kernels:
        check(launches[k] > 0, f"3j {name}: {k} never launched")
    first_tokens_match(f"3j {name}", [t[0] for t in out], logits)
    if cfg.family != "hybrid":
        budgets = [FAMILY_NEW, FAMILY_NEW - 4] * 2
        with LLM(cfg, params, max_len=prompt_len + FAMILY_NEW) as llm:
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            outs = llm.generate([GenRequest(list(p), n)
                                 for p, n in zip(prompts, budgets)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            blaunches = ops.launch_counts()
            check(llm.last_executor == "batcher", f"3j {name}: executor "
                  f"{llm.last_executor}, want batcher")
            check(isinstance(llm.backend, ScanResidentBackend),
                  f"3j {name}: batcher backend {type(llm.backend)}")
        log(f"3j {name} batcher: budgets {budgets}: wall {wall:.3f} s, "
            f"launches={blaunches}")
        check([len(o.tokens) for o in outs] == budgets,
              f"3j {name} batcher: short outputs")
        for k in kernels:
            check(blaunches[k] > 0, f"3j {name} batcher: {k} never launched")
        first_tokens_match(f"3j {name} batcher", [o.tokens[0] for o in outs],
                           logits)
    del params, llm
    torch.cuda.empty_cache()
    return {"launches": launches, "tally": tally, "cfg": cfg,
            "prompt": prompt_len}


def run_families(seed):
    """Phase 3j: Gemma-2-2B, MiniCPM3-4B and Zamba2-1.2B at full depth and
    Llama-4 Scout at ``SCOUT_LAYERS`` of 48 layers (about 40 GB of bf16
    weights), each at full width through ``LLM(paged=False)``."""
    runs = {}
    for name, layers, prompt_len in (
            ("gemma2-2b", None, GEMMA_PROMPT),
            ("minicpm3-4b", None, FAMILY_PROMPT),
            ("llama4-scout-17b-16e", SCOUT_LAYERS, FAMILY_PROMPT),
            ("zamba2-1.2b", None, FAMILY_PROMPT)):
        t0 = time.perf_counter()
        runs[name] = run_family(name, layers, prompt_len, seed)
        log(f"phase 3j {name}: {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 3l: Whisper-small, LLaVA-NeXT-Mistral-7B and Nemotron-4-340B
# ---------------------------------------------------------------------------

# 3l's shape keys, each a call's whole shape: flash (B, Hq, Hkv, Sq, Skv,
# D, causal), decode (B, Hq, Hkv, T, D, int8 cache), matmul (rows, K, N,
# activation, bias), gated_matmul and rmsnorm as in 3j, the paged kernels
# by (B, S, each row's kv end)
ARCH_KEYS = {
    "flash_attention": lambda q, k, v, **kw: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
        q.shape[3], kw.get("causal", True)),
    "decode_attention": lambda q, k, v, kv_len, **kw: (
        q.shape[0], q.shape[1], k.shape[1], k.shape[2], q.shape[2],
        k.dtype == torch.int8),
    "matmul": lambda x, w, b=None, **kw: (
        *rows_width(x), w.shape[1], kw.get("activation"), b is not None),
    "gated_matmul": FAMILY_KEYS["gated_matmul"],
    "rmsnorm": FAMILY_KEYS["rmsnorm"],
    "paged_prefill_attention": paged_key,
    "paged_decode_attention": paged_key,
}


def encdec_launches(cfg, new_tokens):
    """What the route rule predicts for one ``Generator.generate`` of the
    encoder-decoder: at the prefill a flash-attention launch per encoder
    layer (non-causal over the frames) and two per decoder layer (causal
    self-attention from position 0, non-causal cross attention over the
    frames); at each decode step two flash-decode launches per decoder
    layer (self-attention, and cross attention over all ``encoder_seq``
    keys); one ``matmul`` (bias, GELU) per MLP and forward — the
    encoder's and the decoder's at the prefill, the decoder's at each
    step; LayerNorm everywhere, so no RMSNorm."""
    steps = new_tokens - 1
    e, n = cfg.encoder_layers, cfg.n_layers
    return {"flash_attention": e + 2 * n, "decode_attention": 2 * n * steps,
            "plain_dense_attention": 0, "rmsnorm": 0, "gated_matmul": 0,
            "matmul": e + n * new_tokens}


def embeds_batch(cfg, b, s, seed, device="cpu"):
    """A seeded batch as ``configs.shapes.input_specs`` lays it out: the
    VLM's patch embeddings in place of tokens, the encoder-decoder's
    frames beside them; and (B,) tokens for a decode step."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.embeds_input:
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s))
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))
    batch = {k: torch.from_numpy(v.astype(np.int32 if k == "tokens"
                                          else np.float32)).to(device)
             for k, v in batch.items()}
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)
                             .astype(np.int32)).to(device)
    return batch, first


def _embeds_prefill_and_step(cfg, params, batch, first, device):
    """Prefill logits at every position of an ``embeds_batch`` and one
    decode step's after them (fed ``first``), both fp32 on the CPU."""
    x = batch.get("embeds", batch.get("tokens"))
    b, s = x.shape[:2]
    cache, logits = M.prefill(cfg, params,
                              {k: v.to(device) for k, v in batch.items()},
                              M.init_cache(cfg, b, s + 1, device=device),
                              all_logits=True)
    _, step = M.decode_step(cfg, params, first.to(device), cache)
    return logits.float().cpu(), step.float().cpu()


def check_small_embeds(cfg, seed, prompt_len=24):
    """The reduced VLM or encoder-decoder on the card and on the CPU, fed
    embeddings (and frames): in fp32 ``Generator.generate`` gives
    identical greedy tokens; in bf16 the prefill logits at every position
    and one decode step's agree within ``BF16_MODEL_TOL`` of the largest
    |logit| (:func:`check_small_bf16`; the VLM also over an int8 cache)."""
    small = reduced(cfg)
    params = M.init_params(small, seed, device="cpu")
    batch, _ = embeds_batch(small, 3, prompt_len, seed)
    want = Generator(small, params).generate(batch, 8).tokens
    got = Generator(small, M.tree_to(params, "cuda")).generate(batch, 8) \
        .tokens
    log(f"small reference {small.name}: card tokens == CPU tokens: "
        f"{got == want}")
    check(got == want, f"{small.name}: card tokens differ from the CPU's")
    batch, first = embeds_batch(small, 8, prompt_len, seed + 1)
    for kv_dtype in ((None, "int8") if small.family == "vlm" else (None,)):
        bf = dataclasses.replace(small, dtype="bfloat16", kv_dtype=kv_dtype)
        check_small_bf16(f"small bf16 {small.family} kv={kv_dtype or 'bf16'}",
                         bf, seed, lambda c, p, dev: _embeds_prefill_and_step(
                             c, p, batch, first, dev), BF16_MODEL_TOL)


def run_generate(run, cfg, gen, batch, new_tokens, want):
    """One ``Generator.generate`` with the counters zeroed just before and
    read just after, the calls tallied by :data:`ARCH_KEYS`; checks the
    launches ``want`` predicts and logs prefill s, decode tok/s and the
    peak memory.  Returns the result, the launches and the tally."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, tally = tally_rows(lambda: gen.generate(batch, new_tokens),
                            tuple(ARCH_KEYS), ARCH_KEYS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    toks = res.tokens
    check(all(len(t) == new_tokens for t in toks), f"{run}: short outputs")
    check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
          f"{run}: token out of vocab")
    log(f"{run}: batch {len(toks)}, {new_tokens} new each: wall "
        f"{wall:.3f} s, prefill {res.prefill_s:.4f} s, decode "
        f"{res.decode_s:.4f} s ({res.tokens_per_s:.3f} tok/s), "
        f"peak_device_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, launches={launches}")
    log(f"{run}: calls by shape { {k: v for k, v in tally.items() if v} }")
    check_launches(run, launches, want)
    return res, launches, tally


def _init_on_card(run, cfg, seed):
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"{run} init: {time.perf_counter() - t0:.1f} s, {n / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
        f"card")
    return params


def _model_line(run, cfg, full):
    log(f"{run} model: {full.name} at full width, {cfg.n_layers} of "
        f"{full.n_layers} layers, d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} ffn={cfg.d_ff} mlp={cfg.mlp_kind} "
        f"norm={cfg.norm_kind} vocab={cfg.vocab_size} dtype={cfg.dtype}"
        + (f" encoder {cfg.encoder_layers} layers over {cfg.encoder_seq} "
           f"frames" if cfg.encoder_layers else ""))


def run_whisper(seed):
    """3l(b): Whisper-small whole (12 + 12 layers, bf16) through
    ``Generator.generate``: ``WHISPER_BATCH`` rows of random frame
    embeddings and Whisper's start-of-transcript prefix, ``WHISPER_NEW``
    new tokens, with the launches :func:`encdec_launches` predicts and
    first tokens equal to the prefill logits' argmax."""
    cfg = get_config("whisper-small")
    _model_line("3l", cfg, cfg)
    check_small_embeds(cfg, seed)
    params = _init_on_card("3l whisper-small", cfg, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    b = WHISPER_BATCH
    batch = {"tokens": torch.tensor([WHISPER_PREFIX] * b, dtype=torch.int32,
                                    device="cuda"),
             "enc_embeds": torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                       generator=gen, device="cuda")
             .to(torch.bfloat16)}
    _, logits = M.prefill(cfg, params, batch, M.init_cache(
        cfg, b, len(WHISPER_PREFIX) + WHISPER_NEW, device="cuda"))
    check(bool(torch.isfinite(logits).all()), "3l whisper: non-finite logits")
    res, launches, tally = run_generate(
        "3l whisper-small", cfg, Generator(cfg, params), batch, WHISPER_NEW,
        encdec_launches(cfg, WHISPER_NEW))
    for k in ("flash_attention", "decode_attention", "matmul"):
        check(launches[k] > 0, f"3l whisper: {k} never launched")
    first_tokens_match("3l whisper-small", [t[0] for t in res.tokens],
                       logits)
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg, "tally": tally, "new": WHISPER_NEW,
            "prefill_s": res.prefill_s, "tok_s": res.tokens_per_s}


def run_llava(seed):
    """3l(c): LLaVA-NeXT-Mistral-7B whole (32 layers, bf16) through
    ``Generator.generate`` from anyres patch embeddings (``LLAVA_BATCH``
    x ``LLAVA_PATCHES``), ``LLAVA_NEW`` new tokens, with the launches of a
    Mistral one-shot run and first tokens equal to the argmax; then
    offloaded: ``HeteGenBackend`` at ``LLAVA_OFFLOAD_LAYERS`` layers in
    fp32 (the offloaded path's dtype), its prefill logits over
    ``LLAVA_OFFLOAD_PATCHES`` patches held against ``ResidentBackend``'s
    within ``LOGIT_TOL``, then ``LLAVA_OFFLOAD_NEW`` new tokens."""
    cfg = get_config("llava-next-mistral-7b")
    _model_line("3l", cfg, cfg)
    check_small_embeds(cfg, seed)
    params = _init_on_card("3l llava", cfg, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    b = LLAVA_BATCH
    batch = {"embeds": torch.randn((b, LLAVA_PATCHES, cfg.d_model),
                                   generator=gen, device="cuda")
             .to(torch.bfloat16)}
    _, logits = M.prefill(cfg, params, batch, M.init_cache(
        cfg, b, LLAVA_PATCHES + LLAVA_NEW, device="cuda"))
    check(bool(torch.isfinite(logits).all()), "3l llava: non-finite logits")
    res, launches, tally = run_generate(
        "3l llava", cfg, Generator(cfg, params), batch, LLAVA_NEW,
        expected_oneshot_launches(cfg, LLAVA_NEW, resident=True))
    first_tokens_match("3l llava", [t[0] for t in res.tokens], logits)
    del params, logits
    torch.cuda.empty_cache()

    off = dataclasses.replace(cfg, n_layers=LLAVA_OFFLOAD_LAYERS,
                              dtype="float32")
    log(f"3l llava offloaded: {off.n_layers} of {cfg.n_layers} layers in "
        f"float32 (cuts: depth, and the offloaded path serves fp32 host "
        f"weights), {b} x {LLAVA_OFFLOAD_PATCHES} patches, "
        f"{LLAVA_OFFLOAD_NEW} new tokens")
    p_off = _init_on_card("3l llava offloaded", off, seed)
    host = M.tree_to(p_off, "cpu")
    emb = {"embeds": torch.randn((b, LLAVA_OFFLOAD_PATCHES, off.d_model),
                                 generator=gen, device="cuda")}
    rb = ResidentBackend(off, p_off, device="cuda")
    _, want = rb.prefill(emb, rb.init_cache(b, LLAVA_OFFLOAD_PATCHES))
    del rb, p_off
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hb = HeteGenBackend(off, host, batch=b, device="cuda")
    log(f"3l llava offloaded load: {time.perf_counter() - t0:.3f} s")
    try:
        _, got = hb.prefill(emb, hb.init_cache(b, LLAVA_OFFLOAD_PATCHES))
        check(bool(torch.isfinite(got).all()),
              "3l llava offloaded: non-finite logits")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        log(f"3l llava offloaded prefill logits HeteGen(fp) vs Resident: "
            f"max_abs_err={err:.3e} max|logit|={scale:.3e} "
            f"tol={LOGIT_TOL:.0e} relative")
        check(err <= LOGIT_TOL * max(scale, 1.0),
              "3l llava offloaded: prefill logits disagree")
        hb.reset_stats()
        ores, olaunches, _ = run_generate(
            "3l llava offloaded", off, Generator(off, backend=hb), emb,
            LLAVA_OFFLOAD_NEW,
            expected_oneshot_launches(off, LLAVA_OFFLOAD_NEW,
                                      resident=False))
        st = hb.finish_stats()
        pols = {ph: (pol.alpha, sorted({p.mode for p in pol.plan}))
                for ph, pol in hb.policies.items()}
        log(f"3l llava offloaded: stream busy_s cpu={st.cpu:.3f} "
            f"pin={st.pin:.3f} trans={st.trans:.3f} dev={st.dev:.3f} "
            f"wall={st.wall:.3f}, plans (alpha, modes) {pols}")
        check(any("hetegen" in m for _, m in pols.values()),
              "3l llava offloaded: no weight split between host and card")
        first_tokens_match("3l llava offloaded",
                           [t[0] for t in ores.tokens], want)
    finally:
        hb.close()
    del host
    return {"cfg": cfg, "tally": tally, "new": LLAVA_NEW,
            "prefill_s": res.prefill_s, "tok_s": res.tokens_per_s,
            "offload_tok_s": ores.tokens_per_s,
            "offload_prefill_s": ores.prefill_s}


def nemotron_reckoning(cfg):
    """Bytes of the bf16 weights: (embedding, head, one layer)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    layer = attn + 2 * d * f + 4 * d          # two LayerNorms' scale, bias
    by = 2
    return cfg.vocab_size * d * by, d * cfg.vocab_size * by, layer * by


def run_nemotron(seed):
    """3l(d): Nemotron-4-340B at full width and ``NEMOTRON_LAYERS`` of 96
    layers, bf16: ``LLM(cfg, params).generate`` of four
    ``NEMOTRON_PROMPT``-token prompts, ``NEMOTRON_NEW`` new each, one-shot
    (flash and flash-decode at head dim 192, a GQA group of 12, the
    squared-ReLU ``matmul``), then ``LLM(paged=True)`` over bf16 and over
    int8 pages with ragged budgets, so that the batcher serves them (the
    paged kernels at head dim 192); launches as predicted and first
    tokens equal to the prefill logits' argmax.  A reduced
    Nemotron, and the same at head dim 192, run card against CPU first."""
    full = get_config("nemotron-4-340b")
    cfg = dataclasses.replace(full, n_layers=NEMOTRON_LAYERS)
    _model_line("3l", cfg, full)
    emb_b, head_b, layer_b = nemotron_reckoning(cfg)
    reckoned = emb_b + head_b + cfg.n_layers * layer_b
    log(f"3l nemotron reckoning: {emb_b / 1e9:.2f} GB embedding + "
        f"{head_b / 1e9:.2f} GB head + {cfg.n_layers} x "
        f"{layer_b / 1e9:.2f} GB a layer = {reckoned / 1e9:.2f} GB")
    check_small_reference(full, seed, prompt_len=48)
    check_small_reference(full, seed, prompt_len=48, small=dataclasses.replace(
        reduced(full), head_dim=192))
    torch.cuda.reset_peak_memory_stats()
    params = _init_on_card("3l nemotron", cfg, seed)
    log(f"3l nemotron weights: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"on the card against {reckoned / 1e9:.2f} GB reckoned, init peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(seed + 9)
    prompts = [list(rng.integers(0, cfg.vocab_size, NEMOTRON_PROMPT))
               for _ in range(4)]
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    _, logits = M.prefill(cfg, params, {"tokens": toks}, M.init_cache(
        cfg, len(prompts), NEMOTRON_PROMPT + NEMOTRON_NEW, device="cuda"))
    check(bool(torch.isfinite(logits).all()), "3l nemotron: non-finite "
          "logits")
    want = {**expected_oneshot_launches(cfg, NEMOTRON_NEW, resident=True),
            "rmsnorm": 0}
    (out, launches, llm), tally = tally_rows(
        lambda: run_oneshot("3l nemotron", lambda: LLM(cfg, params), prompts,
                            NEMOTRON_NEW, cfg), tuple(ARCH_KEYS), ARCH_KEYS)
    llm.close()
    log(f"3l nemotron: calls by shape { {k: v for k, v in tally.items() if v} }")
    check_launches("3l nemotron", launches, want)
    first_tokens_match("3l nemotron", [t[0] for t in out], logits)
    oneshot_peak = torch.cuda.max_memory_allocated()
    paged = {}
    budgets = [NEMOTRON_NEW, NEMOTRON_NEW - 4] * 2    # ragged: the batcher
    for kv_dtype in (None, "int8"):
        run = f"3l nemotron paged kv={kv_dtype or 'bf16'}"
        llm = LLM(cfg, params, paged=True, kv_dtype=kv_dtype, max_slots=4,
                  max_len=NEMOTRON_PROMPT + NEMOTRON_NEW,
                  page_size=PAGE_SIZE)
        calls = count_calls(llm.backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs, ptally = tally_rows(
            lambda: llm.generate([GenRequest(list(p), n)
                                  for p, n in zip(prompts, budgets)]),
            tuple(ARCH_KEYS), ARCH_KEYS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pl = ops.launch_counts()
        check(llm.last_executor == "batcher",
              f"{run}: executor {llm.last_executor}, want batcher")
        ptoks = [o.tokens for o in outs]
        log(f"{run}: wall {wall:.3f} s ({sum(map(len, ptoks)) / wall:.3f} "
            f"tok/s), forwards {calls}, peak_device_mem="
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches={pl}, calls by shape "
            f"{ {k: v for k, v in ptally.items() if v} }")
        del llm.backend.prefill, llm.backend.decode
        llm.close()
        n_fwd = calls["prefill"] + calls["decode"]
        check(calls["prefill"] > 0 and calls["decode"] > 0,
              f"{run}: no prefill or no decode forward")
        check_launches(run, pl, {
            "paged_prefill_attention": cfg.n_layers * calls["prefill"],
            "paged_decode_attention": cfg.n_layers * calls["decode"],
            "rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
            "plain_dense_attention": 0, **mlp_launches(cfg, n_fwd)})
        check([len(t) for t in ptoks] == budgets, f"{run}: short outputs")
        first_tokens_match(run, [t[0] for t in ptoks], logits)
        paged[kv_dtype or "bf16"] = {"launches": pl, "tally": ptally}
    del params, logits
    torch.cuda.empty_cache()
    log(f"3l nemotron: peak {oneshot_peak / 1e9:.2f} GB one-shot against "
        f"{reckoned / 1e9:.2f} GB of weights reckoned")
    return {"cfg": cfg, "tally": tally, "new": NEMOTRON_NEW,
            "paged": paged, "launches": launches}


def run_new_archs(seed):
    """Phase 3l: Whisper-small, LLaVA-NeXT-Mistral-7B and Nemotron-4-340B
    (:func:`run_whisper`, :func:`run_llava`, :func:`run_nemotron`)."""
    runs = {}
    for name, fn in (("whisper-small", run_whisper),
                     ("llava-next-mistral-7b", run_llava),
                     ("nemotron-4-340b", run_nemotron)):
        t0 = time.perf_counter()
        runs[name] = fn(seed)
        log(f"phase 3l {name}: {time.perf_counter() - t0:.1f} s")
    return runs



def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def offload_prompts(vocab, seed):
    rng = np.random.default_rng(seed + 1)
    return [list(rng.integers(0, vocab, OFFLOAD_PROMPT)) for _ in range(4)]


def compare_dense_prefill_logits(cfg, params, host_params, prompts):
    """3c's check: HeteGen(fp) prefill logits over the dense backend cache
    against ResidentBackend's (run while the weights are on the card)."""
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    b, s = toks.shape

    def prefill(be):
        return be.prefill({"tokens": toks}, be.init_cache(b, s))[1]

    want = prefill(ResidentBackend(cfg, params, device="cuda"))
    hb = HeteGenBackend(cfg, host_params, batch=b, device="cuda")
    try:
        got = prefill(hb)
    finally:
        hb.close()
    check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"3c dense-cache prefill logits HeteGen(fp) vs Resident: "
        f"max_abs_err={err:.3e} max|logit|={scale:.3e} "
        f"tol={LOGIT_TOL:.0e} relative")
    check(err <= LOGIT_TOL * max(scale, 1.0), "3c prefill logits disagree")
    return got


def run_offload_oneshot(cfg, host_params, prompts):
    """Phase 3c: OPT offloaded one-shot over the dense backend cache."""
    t0 = time.perf_counter()
    be = HeteGenBackend(cfg, host_params, batch=len(prompts), device="cuda")
    be.retune(len(prompts), phase="prefill", tokens_per_seq=len(prompts[0]))
    log(f"3c load: {time.perf_counter() - t0:.3f} s")
    toks, launches, llm = run_oneshot(
        "3c opt offloaded", lambda: LLM(cfg, backend=be, own_backend=True),
        prompts, OFFLOAD_NEW, cfg)
    st = be.finish_stats()
    log(f"3c stream busy_s cpu={st.cpu:.3f} pin={st.pin:.3f} "
        f"trans={st.trans:.3f} dev={st.dev:.3f} wall={st.wall:.3f}, "
        f"alpha decode={be.policies['decode'].alpha} "
        f"prefill={be.policies['prefill'].alpha}")
    llm.close()
    check_launches("3c", launches, expected_oneshot_launches(
        cfg, OFFLOAD_NEW, resident=False))
    return launches


def run_opt_resident(cfg, params, prompts, hetegen_logits):
    """Phase 3f: OPT resident one-shot (fp32) on the stacked cache, each
    layer's fc1 (bias, ReLU) through the ``matmul`` kernel.  Its prefill
    logits are held against 3c's HeteGen(fp) prefill logits on the same
    prompts; returns the launch counts and the ``matmul`` launches by
    (rows, width)."""
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    b, s = toks.shape
    _, logits = M.prefill(cfg, params, {"tokens": toks},
                          M.init_cache(cfg, b, s, device="cuda"))
    check(bool(torch.isfinite(logits).all()), "3f: non-finite logits")
    err = float((logits - hetegen_logits).abs().max())
    scale = float(hetegen_logits.abs().max())
    log(f"3f prefill logits whole model vs HeteGen(fp) (3c): "
        f"max_abs_err={err:.3e} max|logit|={scale:.3e} tol={LOGIT_TOL:.0e} "
        f"relative")
    check(err <= LOGIT_TOL * max(scale, 1.0), "3f prefill logits disagree")
    first = torch.argmax(logits, dim=-1).tolist()
    del logits
    (out, launches, llm), tally = tally_rows(
        lambda: run_oneshot("3f opt resident", lambda: LLM(cfg, params),
                            prompts, OFFLOAD_NEW, cfg), ("matmul",))
    llm.close()
    check_launches("3f", launches, expected_oneshot_launches(
        cfg, OFFLOAD_NEW, resident=True))
    rows = tally["matmul"]
    want = {(b * s, cfg.d_model): cfg.n_layers,
            (b, cfg.d_model): cfg.n_layers * (OFFLOAD_NEW - 1)}
    log(f"3f: matmul launches by (rows, width) {rows}")
    check(rows == want, f"3f: matmul launches by shape {rows}, want {want}")
    check([t[0] for t in out] == first,
          "3f: first tokens differ from the prefill logits' argmax")
    return {"launches": launches, "matmul_rows": rows}


# ---------------------------------------------------------------------------
# phase 4b: the dense-cache kernels against their plain versions
# ---------------------------------------------------------------------------

def dense_cache(gen, b, hkv, t, d, dtype, layout):
    """K/V (+ int8 scales) as the stacked cache's layer slice (B, Hkv, T,
    D), or the backend's (B, T, Hkv, D) buffer through transpose(1, 2)."""
    shape = (b, hkv, t, d) if layout == "bhtd" else (b, t, hkv, d)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02
        vs = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02
    else:
        k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        ks = vs = None
    if layout == "bthd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if ks is not None:
            ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
    return k, v, ks, vs


def sdpa(q, k, v, **kw):
    """One PyTorch attention call (GQA through ``enable_gqa``) as the
    library yardstick."""
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


def rejects(bad, want, limit, what):
    """The limit must fail a plain version with a known fault (so a kernel
    with that fault could not pass it); logs the share of elements it
    rejects."""
    beyond = float(((bad.float() - want.float()).abs() > limit)
                   .float().mean())
    log(f"control {what}: {beyond:.3g} of elements beyond the limit")
    check(beyond > 0, f"the limit would pass {what}")


def flash_scores_bf16(q, k, v, window=None, softcap=None, causal=True):
    """The plain flash attention (causal unless ``causal`` is False) with
    the fault a tensor-core kernel invites: each score q . k rounded to
    bf16 before the scale (the softcap and the window as the plain version
    applies them) and the softmax."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    s = s.to(torch.bfloat16).float() / (d ** 0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(skv, device=q.device)[None, :]
    qpos = torch.arange(sq, device=q.device)[:, None]
    ok = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
    if window is not None:
        ok &= kpos > qpos - window
    p = torch.softmax(torch.where(ok, s, ref.NEG_INF), dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def rms_faults(x, w, eps, plus_one=False):
    """Plain RMSNorms with one fault each, all within one bf16 step of the
    plain version: squares rounded to bf16 before the mean, x * rsqrt
    rounded to bf16 before the scale, the mean over D - 1."""
    xf, wf = x.float(), w.float() + (1.0 if plus_one else 0.0)
    d = x.shape[-1]
    sq = xf * xf

    def norm(var):
        return (xf * torch.rsqrt(var + eps) * wf).to(x.dtype)

    return {
        "squares rounded to bf16": norm(sq.to(x.dtype).float()
                                        .mean(-1, keepdim=True)),
        "x * rsqrt rounded to bf16": (
            (xf * torch.rsqrt(sq.mean(-1, keepdim=True) + eps))
            .to(x.dtype).float() * wf).to(x.dtype),
        "a mean over D - 1": norm(sq.sum(-1, keepdim=True) / (d - 1)),
    }


def rms_entry(name, gen, cfg, rows, d, launches, *, plus_one=False):
    """The RMSNorm kernel on a bf16 (rows, d) input against its plain
    version (the scale ``1 + w`` with ``plus_one``, Gemma's), within
    ``ref.rmsnorm_limit`` and bit-equal to it but for at most
    ``ref.RMSNORM_UNEQUAL_MAX`` of the elements, a check each of three
    faults that stay within the limit must fail; timed beside
    ``F.rms_norm`` (with ``plus_one`` over ``1 + w`` rounded to bf16
    once, outside the timed call)."""
    x = torch.randn((rows, d), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    w = torch.randn(d, generator=gen, device="cuda").to(torch.bfloat16)
    eps = cfg.norm_eps
    kw = dict(eps=eps, plus_one=plus_one)
    got = k_rms.rmsnorm(x, w, **kw)
    want = ref.rmsnorm(x, w, **kw)
    share = ref.unequal_share(got, want)
    log(f"kernel {name}: {share:.2e} of elements not bit-equal to the "
        f"plain version (at most {ref.RMSNORM_UNEQUAL_MAX:.0e})")
    check(share <= ref.RMSNORM_UNEQUAL_MAX,
          f"{name}: {share:.2e} of elements not bit-equal")
    w_lib = (w.float() + 1.0).to(w.dtype) if plus_one else w
    for what, bad in rms_faults(x, w, eps, plus_one).items():
        bad_share = ref.unequal_share(bad, want)
        log(f"control {name}, {what}: {bad_share:.2e} of elements not "
            f"bit-equal")
        check(bad_share > ref.RMSNORM_UNEQUAL_MAX,
              f"the bit check would pass {what} at {name}")
    return kernel_entry(
        name, "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:41", launches, got, want,
        ref.rmsnorm_limit(want), lambda: k_rms.rmsnorm(x, w, **kw),
        lambda: ref.rmsnorm(x, w, **kw),
        lambda: F.rms_norm(x, (d,), w_lib, eps),
        (2 * x.numel() + d) * 2, 4 * x.numel(), BF16_FLOPS)


def decode_entry(name, gen, cfg, dtype, kv_dt, layout, t, lens, launches, *,
                 softcap=None, qscale=1.0, hot_last=None):
    """The flash-decode kernel on B = len(lens) rows of a random cache of
    ``t`` positions (``qscale`` widens q, so that a ``softcap`` bites),
    held by :func:`hold_decode`; timed beside the plain version and the
    library call: ``F.scaled_dot_product_attention`` with a length mask
    (no int8), or with a softcap ``flex_attention``
    (:func:`flex_library`).  ``hot_last`` sets each row's last key along its
    kv-group's mean query, scored about ``hot_last`` before the softcap
    (a recent token drawing most of the weight; its share is logged), so
    that an off-by-one mask shows over thousands of keys; before that,
    the same shape is held on the unshaped cache, where the bulk of the
    keys carries the weight and the mask's off-by-one is out of sight."""
    b = len(lens)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q8 = kv_dt == torch.int8
    k, v, ks, vs = dense_cache(gen, b, hkv, t, d, kv_dt, layout)
    q = (torch.randn((b, hq, d), generator=gen, device="cuda")
         * qscale).to(dtype)
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap)
    if hot_last is not None:
        run = f"{name} on the unshaped cache"
        got, want, limit = hold_decode(run, q, k, v, kl, kw,
                                       mask_control=False)
        err, ratio = excess(got, want, limit)
        log(f"kernel {run}: max_abs_err={err:.3e} worst err/limit="
            f"{ratio:.3f}")
        check(ratio <= 1.0, f"{run}: worst error {ratio:.3f} x its limit")
        qg = q.float().reshape(b, hkv, hq // hkv, d).mean(2)
        hot = qg * (hot_last * d ** 0.5
                    / qg.pow(2).sum(-1, keepdim=True))
        for i, n in enumerate(lens):           # k is (B, Hkv, T, D) in
            k[i, :, n - 1] = hot[i].to(k.dtype)  # either layout
        share = last_key_share(q, k, kl, softcap)
        log(f"kernel {name}: the hot last key's softmax share over the "
            f"rows and heads: min {float(share.min()):.4f} mean "
            f"{float(share.mean()):.4f} max {float(share.max()):.4f}")
    got, want, limit = hold_decode(name, q, k, v, kl, kw)
    lib = None
    if softcap is not None:
        lib = flex_library(q, k, v, want, limit, softcap=softcap, lens=kl)
    elif not q8:
        mask = (torch.arange(t, device="cuda")[None, :]
                < kl[:, None].long())[:, None, None, :]
        lib = sdpa(q[:, :, None], k, v, attn_mask=mask)
    el = q.element_size()
    kvb = (1 if q8 else el) * 2 * hkv * d * sum(lens) \
        + (8 * hkv * sum(lens) if q8 else 0)
    return kernel_entry(
        name, "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:151", launches, got,
        want, limit,
        lambda: k_dense.decode_attention(q, k, v, kl, **kw),
        lambda: ref.decode_attention(q, k, v, kl, **kw), lib,
        2 * q.numel() * el + kvb + 4 * b, 4 * hq * d * sum(lens),
        BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)


def hold_decode(run, q, k, v, kl, kw, *, mask_control=True):
    """The kernel's output on these inputs (the same on two calls), the
    plain version's and the per-element limit, the limit shown to reject
    an off-by-one mask (``mask_control``), 64 values lost mid-sequence in
    each row (one block of a split-KV sum dropped or combined with the
    wrong weight) and, with a softcap, the scores without it."""
    got = k_dense.decode_attention(q, k, v, kl, **kw)
    check(torch.equal(k_dense.decode_attention(q, k, v, kl, **kw), got),
          f"{run}: two calls differ")
    want = ref.decode_attention(q, k, v, kl, **kw)
    limit = ref.decode_attention_limit(q, k, v, kl, want, **kw)
    if mask_control:
        rejects(ref.decode_attention(q, k, v, kl - 1, **kw), want, limit,
                f"{run}, an off-by-one mask")
    lost = v.clone()
    for i, n in enumerate(kl.tolist()):
        lo = max(n // 2 - 32, 0)
        lost[i, :, lo:lo + 64] = 0
    rejects(ref.decode_attention(q, k, lost, kl, **kw), want, limit,
            f"{run}, 64 values lost mid-sequence")
    if kw["softcap"] is not None:
        rejects(ref.decode_attention(q, k, v, kl, k_scale=kw["k_scale"],
                                     v_scale=kw["v_scale"]),
                want, limit, f"{run}, scores without their softcap")
    return got, want, limit


def last_key_share(q, k, kl, softcap):
    """Each row's and head's softmax weight on its last key (kv_len - 1),
    from the plain scores of a 16-bit cache (B, Hkv, T, D)."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    sc = torch.einsum("bkgd,bktd->bkgt",
                      q.float().reshape(b, hkv, hq // hkv, d), k.float())
    sc = sc / d ** 0.5
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    past = torch.arange(t, device=q.device) >= kl.long()[:, None]
    p = torch.softmax(sc.masked_fill(past[:, None, None], -math.inf), -1)
    last = (kl.long() - 1)[:, None, None, None].expand(b, hkv, hq // hkv, 1)
    return p.gather(-1, last)


def flex_library(q, k, v, want, limit, *, softcap, window=None, lens=None):
    """``flex_attention`` under ``torch.compile``, the softcap as its
    ``score_mod`` and, as its block mask, the causal window (flash: q
    (B, Hq, S, D)) or each row's length ``lens`` (decode: q (B, Hq, D)):
    the one PyTorch call that computes a softcapped attention, timed as
    ``library_ms``.  None, with the reason logged, where it does not
    compile or lies beyond the limit.  Inductor's and Triton's caches go
    under ``smoke_out/``, and it compiles in this process."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(OUT_DIR, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(OUT_DIR, "triton"))
    import torch._inductor.config as inductor_cfg
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    inductor_cfg.compile_threads = 1
    decode = q.dim() == 3
    qq = q[:, :, None] if decode else q

    def cap(score, bi, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def keep(bi, h, qi, ki):
        if decode:
            return ki < lens[bi]
        ok = ki <= qi
        return ok if window is None else ok & (qi - ki < window)

    t0 = time.perf_counter()
    try:
        mask = create_block_mask(keep, q.shape[0] if decode else None, None,
                                 qq.shape[2], k.shape[2], device="cuda")
        fn = torch.compile(flex_attention, dynamic=False)

        def call():
            o = fn(qq, k, v, score_mod=cap, block_mask=mask, enable_gqa=True)
            return o[:, :, 0] if decode else o
        out = call()
    except Exception as e:                  # a yardstick, not a check
        log(f"library flex_attention: not used ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:200] if str(e) else ''})")
        return None
    err, ratio = excess(out, want, limit)
    log(f"library flex_attention: compiled and run in "
        f"{time.perf_counter() - t0:.1f} s, max_abs_err={err:.3e} worst "
        f"err/limit={ratio:.3f}")
    if ratio > 1.0:
        log("library flex_attention: disagrees; not used")
        return None
    return call


def causal_pairs(s, window=None):
    """(query, key) pairs a causal attention over ``s`` positions scores,
    within ``window`` where one is set."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_entry(name, gen, cfg, dtype, layout, s, t, launches, *, b=4,
                window=None, softcap=None, qscale=1.0):
    """The flash-attention kernel over the first ``s`` of ``t`` cache
    positions (causal, optionally within ``window`` and softcapped;
    ``qscale`` widens q so that a softcap bites), within
    ``ref.flash_attention_limit``, the limit shown to reject an
    off-by-one mask, scores rounded to bf16 (in bf16) or q and k rounded
    to TF32 (in fp32), and each of the window and the softcap left out;
    timed beside the plain version and, where one call computes the same
    function, ``F.scaled_dot_product_attention`` (causal, or with the
    window's mask), or with a softcap ``flex_attention``
    (:func:`flex_library`)."""
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k, v, _, _ = dense_cache(gen, b, hkv, t, d, dtype, layout)
    k, v = k[:, :, :s], v[:, :, :s]
    q = (torch.randn((b, s, hq, d), generator=gen, device="cuda")
         * qscale).to(dtype).transpose(1, 2)
    kw = dict(window=window, softcap=softcap)
    got = k_flash.flash_attention(q, k, v, **kw)
    check(torch.equal(k_flash.flash_attention(q, k, v, **kw), got),
          f"{name}: two calls differ")
    want = ref.flash_attention(q, k, v, **kw)
    limit = ref.flash_attention_limit(q, k, v, want, **kw)
    bad = want.clone()                       # query i misses key i
    bad[:, :, 1:] = ref.flash_attention(q[:, :, 1:], k[:, :, :-1],
                                        v[:, :, :-1], **kw)
    rejects(bad, want, limit, f"{name}, an off-by-one mask")
    if dtype == torch.bfloat16:
        rejects(flash_scores_bf16(q, k, v, **kw), want, limit,
                f"{name}, scores rounded to bf16 before the softmax")
    else:
        rejects(ref.flash_attention(tf32(q), tf32(k), v, **kw), want, limit,
                f"{name}, q and k rounded to TF32")
    if window is not None and window < s:
        rejects(ref.flash_attention(q, k, v, softcap=softcap), want, limit,
                f"{name}, keys outside the window")
    if softcap is not None:
        rejects(ref.flash_attention(q, k, v, window=window), want, limit,
                f"{name}, scores without their softcap")
    if softcap is not None:
        lib = flex_library(q, k, v, want, limit, softcap=softcap,
                           window=window)
    elif window is None:
        lib = sdpa(q, k, v, is_causal=True)
    else:
        pos = torch.arange(s, device="cuda")
        ok = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
        lib = sdpa(q, k, v, attn_mask=ok)
    el = q.element_size()
    return kernel_entry(
        name, "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106", launches, got, want,
        limit, lambda: k_flash.flash_attention(q, k, v, **kw),
        lambda: ref.flash_attention(q, k, v, **kw), lib,
        (2 * q.numel() + 2 * k.numel()) * el,
        4 * b * hq * d * causal_pairs(s, window),
        BF16_FLOPS if dtype == torch.bfloat16 else F32_ATTN_PEAK)


def check_dense_kernels(mcfg, ocfg, counts_3b, counts_3c):
    """Each dense-cache kernel against its plain version at the main
    paths' shapes, element by element within the ``ref.*_limit`` bounds,
    timed beside the plain version, one library call and the bound.
    Returns the ``kernels`` entries; the ragged T = 4096 shape, which no
    main path runs, is checked and logged only."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    b = 4
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    t3b = ONESHOT_PROMPT + ONESHOT_NEW
    full = [t3b - 1] * b                    # the last decode step's kv_len
    t3c = OFFLOAD_PROMPT + OFFLOAD_NEW
    rows = counts_3b["bf16_rmsnorm_rows"]
    entries = [
        decode_entry("decode_attention_bf16", gen, mcfg, bf, bf, "bhtd", t3b,
                     full, counts_3b["bf16"]["decode_attention"]),
        decode_entry("decode_attention_q8", gen, mcfg, bf, i8, "bhtd", t3b,
                     full, counts_3b["int8"]["decode_attention"]),
        decode_entry("decode_attention_f32", gen, ocfg, f32, f32, "bthd",
                     t3c, [t3c - 1] * b, counts_3c["decode_attention"]),
        flash_entry("flash_attention_bf16", gen, mcfg, bf, "bhtd",
                    ONESHOT_PROMPT, t3b, counts_3b["bf16"]["flash_attention"]),
        flash_entry("flash_attention_f32", gen, ocfg, f32, "bthd",
                    OFFLOAD_PROMPT, t3c, counts_3c["flash_attention"]),
        rms_entry("rmsnorm_prefill", gen, mcfg, b * ONESHOT_PROMPT,
                  mcfg.d_model, rows.get((b * ONESHOT_PROMPT, mcfg.d_model),
                                         0)),
        rms_entry("rmsnorm_decode", gen, mcfg, b, mcfg.d_model,
                  rows.get((b, mcfg.d_model), 0)),
    ]
    # the ragged kv_len at T = 4096 in both layouts: not a main-path shape
    ragged = [512, 1100, 2048, 3001]
    for name, kv_dt, layout in (("bf16_ragged_bhtd", bf, "bhtd"),
                                ("bf16_ragged_bthd", bf, "bthd"),
                                ("q8_ragged_bhtd", i8, "bhtd")):
        decode_entry("decode_attention_" + name, gen, mcfg, bf, kv_dt,
                     layout, 4096, ragged, "none (not a main-path shape)")
    return entries


# ---------------------------------------------------------------------------
# phase 4c: the SSD intra-chunk kernel against its plain version
# ---------------------------------------------------------------------------

def ssd_inputs(gen, bs, ln, cfg, dtype):
    """The kernel's operands as the Mamba2 block makes them: x, and B/C
    broadcast from their groups to the heads (a stride-0 view for one
    group); dt after softplus over ``dt_bias`` = -1; a = -exp(A_log) =
    -1 as initialized."""
    from repro_torch.models.ssm import heads_of_groups
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    x = torch.randn((bs, ln, h, p), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((bs, ln, h), generator=gen, device="cuda")
                    - 1.0)
    a = -torch.ones(h, device="cuda")
    bc = torch.randn((bs, ln, 2 * g * n), generator=gen,
                     device="cuda").to(dtype)
    b = heads_of_groups(bc[..., :g * n].reshape(bs, ln, g, n), h)
    c = heads_of_groups(bc[..., g * n:].reshape(bs, ln, g, n), h)
    return x, dt, a, b, c, bc


def ssd_y_bf16_g(x, dt, a, b, c, chunk):
    """y_intra as the plain version computes it, but with the decay-masked
    G = C B^T o exp(cum_i - cum_j) rounded to bf16 before G (dt x), as a
    tensor-core product fed bf16 operands would: a control the y limit
    must reject."""
    bs, ln, h, p = x.shape
    nc, n = ln // chunk, b.shape[-1]
    dtc = dt.reshape(bs, nc, chunk, h)
    cum = torch.cumsum(dtc * a, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bnkhs,bnlhs->bnklh",
                      c.reshape(bs, nc, chunk, h, n).float(),
                      b.reshape(bs, nc, chunk, h, n).float())
    g = (cb * decay).to(torch.bfloat16).float()
    xdt = x.reshape(bs, nc, chunk, h, p).float() * dtc[..., None]
    return torch.einsum("bnklh,bnlhp->bnkhp", g, xdt).reshape(bs, ln, h, p)


def rejects_every_row(bad, want, limit, chunk, what):
    """The y limit must fail a control in every row position of a chunk,
    the late rows (whose limit is widest) included; logs the share of
    elements rejected and the smallest per-row worst ratio."""
    bs, ln, h, p = want.shape
    ratio = ((bad.float() - want.float()).abs() / limit)
    rows = ratio.reshape(bs, ln // chunk, chunk, h, p).amax(dim=(0, 1, 3, 4))
    log(f"control {what}: {float((ratio > 1).float().mean()):.3f} of "
        f"elements beyond the limit, rows rejected {int((rows > 1).sum())} "
        f"of {chunk}, smallest row worst ratio {float(rows.min()):.3f}")
    check(bool((rows > 1).all()), f"the limit would pass {what}")


def ssd_entry(name, cfg, bs, ln, dtype, launches, gen):
    """One shape of the SSD kernel: the same bits from two calls, each
    output within its per-element limit, the y limit shown to reject
    dropping each row's own term and,
    in every row, a y rounded to bf16 and a y over a bf16 G; timed beside
    the plain version and the bound."""
    chunk = cfg.ssm_chunk
    x, dt, a, b, c, bc = ssd_inputs(gen, bs, ln, cfg, dtype)
    got = k_ssd.ssd_chunk(x, dt, a, b, c, chunk=chunk)
    check(all(torch.equal(u, v) for u, v in
              zip(k_ssd.ssd_chunk(x, dt, a, b, c, chunk=chunk), got)),
          f"{name}: two calls differ")
    want = ref.ssd_chunk(x, dt, a, b, c, chunk=chunk)
    limits = ref.ssd_chunk_limit(x, dt, a, b, c, got[2], chunk=chunk)
    diag = torch.einsum("blhn,blhn->blh", c.float(), b.float())[..., None] \
        * x.float() * dt[..., None]
    rejects(want[0] - diag, want[0], limits[0],
            f"{name}, y without each row's own term")
    rejects_every_row(want[0].to(torch.bfloat16).float(), want[0], limits[0],
                      chunk, f"{name} y_intra rounded to bf16")
    rejects_every_row(ssd_y_bf16_g(x, dt, a, b, c, chunk), want[0],
                      limits[0], chunk, f"{name} y_intra over a bf16 G")
    errs = [excess(gi, wi, li) for gi, wi, li in zip(got, want, limits)]
    for (err, ratio), what in zip(errs, ("y_intra", "state_c", "cum")):
        log(f"kernel {name} {what}: max_abs_err={err:.3e} worst "
            f"err/limit={ratio:.3f}")
        check(ratio <= 1.0, f"{name} {what}: {ratio:.3f} x its limit")
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k, nc = chunk, ln // chunk
    el = x.element_size()
    nbytes = (x.numel() * el + dt.numel() * 4 + a.numel() * 4
              + bc.numel() * el                      # b/c once, per group
              + 4 * (bs * ln * h * p + bs * nc * h * p * n + bs * ln * h))
    tri = k * (k + 1) // 2
    flops = bs * nc * h * (2 * tri * n + 2 * tri * p + 2 * k * p * n)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    entry = kernel_entry(
        name, "src/repro_torch/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk.py:84", launches, got[0], want[0],
        limits[0], lambda: k_ssd.ssd_chunk(x, dt, a, b, c, chunk=chunk),
        lambda: ref.ssd_chunk(x, dt, a, b, c, chunk=chunk), None, nbytes,
        flops, peak)
    entry["max_abs_err"] = max(e for e, _ in errs)
    return entry


def check_ssd_kernel(counts_3d):
    """Phase 4c: the SSD kernel at 3d's shape (in the line) and at the
    reduced model's (logged only), and RMSNorm at 3d's four shapes."""
    gen = torch.Generator(device="cuda").manual_seed(777)
    cfg = get_config("mamba2-2.7b")
    entries = [ssd_entry("ssd_chunk_bf16", cfg, 4, MAMBA_PROMPT,
                         torch.bfloat16, counts_3d["launches"]["ssd_chunk"],
                         gen)]
    ssd_entry("ssd_chunk_f32_reduced", reduced(cfg), 3, 48, torch.float32,
              "none (not a main-path shape)", gen)
    for (rows, d), n in sorted(counts_3d["rmsnorm_rows"].items()):
        phase = "prefill" if rows == 4 * MAMBA_PROMPT else "decode"
        entries.append(rms_entry(f"rmsnorm_mamba_{phase}_d{d}", gen, cfg,
                                 rows, d, n))
    return entries


# ---------------------------------------------------------------------------
# phase 4j: the 3j families' new kernel shapes against their plain versions
# ---------------------------------------------------------------------------

def check_family_kernels(runs):
    """Phase 4j: every shape 3j's tally recorded (:data:`FAMILY_KEYS`) for
    the four kernels it counts, and ``ssd_chunk`` at Zamba2's shape (64
    heads of 64, state 64, chunk 128), each against its plain version with
    4b's / 4c's / 4d's checks and times, with the one-shot run's launches
    of that shape.  A softcap's q is widened by ``SOFTCAP_QSCALE`` so that
    the cap bites, and its decode entry also holds the unshaped cache
    (:func:`decode_entry`).  No earlier phase runs these widths."""
    gen = torch.Generator(device="cuda").manual_seed(2468)
    bf = torch.bfloat16
    entries = []
    for name, run in runs.items():
        tag, cfg, tally = FAMILY_TAGS[name], run["cfg"], run["tally"]
        for (b, hq, hkv, s, d, window, cap), n in sorted(
                tally["flash_attention"].items(), key=str):
            heads = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv,
                                        head_dim=d)
            entries.append(flash_entry(
                f"flash_attention_{tag}_h{hq}x{hkv}_d{d}_s{s}"
                + family_suffix(window, cap), gen, heads, bf, "bhtd", s,
                s + FAMILY_NEW, n, b=b, window=window, softcap=cap,
                qscale=SOFTCAP_QSCALE if cap else 1.0))
        for (b, hq, hkv, t, d, cap), n in sorted(
                tally["decode_attention"].items(), key=str):
            heads = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv,
                                        head_dim=d)
            entries.append(decode_entry(
                f"decode_attention_{tag}_h{hq}x{hkv}_d{d}_t{t}"
                + family_suffix(None, cap), gen, heads, bf, bf, "bhtd", t,
                [t - 1] * b, n, softcap=cap,
                qscale=SOFTCAP_QSCALE if cap else 1.0,
                hot_last=20.0 if cap else None))
        for (m, k, nn, act), n in sorted(tally["gated_matmul"].items(),
                                         key=str):
            entries.append(mm_entry(
                f"gated_matmul_{act}_{tag}_m{m}_{k}x{nn}_"
                + matmul_design(bf, m, k, True), gen, bf, m, k, nn, n,
                gated=True, act=act))
        for (m, d, plus_one), n in sorted(tally["rmsnorm"].items(),
                                          key=str):
            entries.append(rms_entry(
                f"rmsnorm_{tag}_m{m}_d{d}" + ("_plus1" if plus_one else ""),
                gen, cfg, m, d, n, plus_one=plus_one))
        if cfg.family == "hybrid":
            entries.append(ssd_entry(f"ssd_chunk_{tag}_bf16", cfg, 4,
                                     run["prompt"], bf,
                                     run["launches"]["ssd_chunk"], gen))
    return entries


FAMILY_TAGS = {"gemma2-2b": "gemma2", "minicpm3-4b": "minicpm3",
               "llama4-scout-17b-16e": "scout", "zamba2-1.2b": "zamba2"}


def family_suffix(window, cap):
    return (f"_w{window}" if window else "") \
        + (f"_cap{cap:g}" if cap else "")


def flash_full_entry(name, gen, cfg, dtype, sq, skv, launches, *, b=4):
    """The flash-attention kernel with no causal mask: ``sq`` queries over
    every one of ``skv`` keys held as the (B, S, Hkv, D) buffer a
    projection writes, read through ``transpose(1, 2)`` — the encoder's
    self-attention (sq = skv, the frames) or a prompt's cross attention
    over them.  Within ``ref.flash_attention_limit(causal=False)``, the
    limit shown to reject the last 32-key tile dropped, a causal mask
    (where sq > 1) and scores rounded to bf16; timed beside the plain
    version and ``F.scaled_dot_product_attention``.  q is widened
    ``FULL_QSCALE`` times: at unit scores over 1500 keys no key carries
    much weight, and scores rounded to bf16 move the output less than the
    limit's allowance for p rounded to bf16 (a kernel with that fault
    would pass); over sharper scores they do not."""
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k, v, _, _ = dense_cache(gen, b, hkv, skv, d, dtype, "bthd")
    q = (torch.randn((b, sq, hq, d), generator=gen, device="cuda")
         * FULL_QSCALE).to(dtype).transpose(1, 2)
    kw = dict(causal=False)
    got = k_flash.flash_attention(q, k, v, **kw)
    check(torch.equal(k_flash.flash_attention(q, k, v, **kw), got),
          f"{name}: two calls differ")
    want = ref.flash_attention(q, k, v, **kw)
    limit = ref.flash_attention_limit(q, k, v, want, **kw)
    cut = skv - (skv % 32 or 32)
    rejects(ref.flash_attention(q, k[:, :, :cut], v[:, :, :cut], **kw), want,
            limit, f"{name}, the last key tile dropped")
    if sq > 1:
        rejects(ref.flash_attention(q, k, v, causal=True), want, limit,
                f"{name}, a causal mask")
    rejects(flash_scores_bf16(q, k, v, causal=False), want, limit,
            f"{name}, scores rounded to bf16 before the softmax")
    el = q.element_size()
    return kernel_entry(
        name, "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106", launches, got, want,
        limit, lambda: k_flash.flash_attention(q, k, v, **kw),
        lambda: ref.flash_attention(q, k, v, **kw), sdpa(q, k, v),
        (2 * q.numel() + 2 * k.numel()) * el, 4 * b * hq * d * sq * skv,
        BF16_FLOPS)


ARCH_TAGS = {"whisper-small": "whisper", "llava-next-mistral-7b": "llava",
             "nemotron-4-340b": "nemotron"}


def check_arch_kernels(runs):
    """Phase 4l: every shape 3l's one-shot runs tallied (:data:`ARCH_KEYS`)
    — flash attention causal and not (Whisper's encoder over 1500 frames,
    its cross attention from a 4-token prompt, LLaVA's 2880 patches,
    Nemotron's head dim 192 at a GQA group of 12), flash-decode (Whisper's
    self and cross caches, LLaVA's, Nemotron's), bf16 ``matmul`` with GELU
    and bias (Whisper) and squared ReLU (Nemotron), LLaVA's
    ``gated_matmul`` and RMSNorm — and the two most frequent paged prefill
    and decode shapes of each of Nemotron's paged runs (bf16 and int8
    pages, head dim 192), each against its plain version with 4b's and
    4d's checks and times, with its launches in 3l.  One head dim off the
    main paths (96) is checked and logged only."""
    gen = torch.Generator(device="cuda").manual_seed(1357)
    bf = torch.bfloat16
    entries = []
    for name, run in runs.items():
        tag, cfg, tally = ARCH_TAGS[name], run["cfg"], run["tally"]
        for (b, hq, hkv, sq, skv, d, causal), n in sorted(
                tally["flash_attention"].items(), key=str):
            heads = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv,
                                        head_dim=d)
            base = f"flash_attention_{tag}_h{hq}x{hkv}_d{d}"
            if causal:
                entries.append(flash_entry(
                    f"{base}_s{sq}", gen, heads, bf, "bhtd", sq,
                    sq + run["new"], n, b=b))
            else:
                what = "enc" if sq == skv else "cross"
                entries.append(flash_full_entry(
                    f"{base}_{what}_q{sq}_kv{skv}", gen, heads, bf, sq, skv,
                    n, b=b))
        for (b, hq, hkv, t, d, q8), n in sorted(
                tally["decode_attention"].items(), key=str):
            heads = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv,
                                        head_dim=d)
            cross = cfg.family == "encdec" and t == cfg.encoder_seq
            # over more than LONG_DECODE keys of unit scores one key moves
            # the output less than the limit allows, so the off-by-one
            # control needs a hot last key (decode_entry's hot_last),
            # scored 8: about half the weight, the rest still enough for
            # the 64 values lost mid-sequence to show
            entries.append(decode_entry(
                f"decode_attention_{tag}_h{hq}x{hkv}_d{d}_t{t}"
                + ("_cross" if cross else ""), gen, heads, bf,
                torch.int8 if q8 else bf, "bthd" if cross else "bhtd", t,
                [t if cross else t - 1] * b, n,
                hot_last=8.0 if t > LONG_DECODE else None))
        for (m, k, nn, act, bias), n in sorted(tally["matmul"].items(),
                                               key=str):
            entries.append(mm_entry(
                f"matmul_{act}_{tag}_m{m}_{k}x{nn}_"
                + matmul_design(bf, m, k, False), gen, bf, m, k, nn, n,
                gated=False, act=act, bias=bias))
        for (m, k, nn, act), n in sorted(tally["gated_matmul"].items(),
                                         key=str):
            entries.append(mm_entry(
                f"gated_matmul_{act}_{tag}_m{m}_{k}x{nn}_"
                + matmul_design(bf, m, k, True), gen, bf, m, k, nn, n,
                gated=True, act=act))
        for (m, d, plus_one), n in sorted(tally["rmsnorm"].items(), key=str):
            entries.append(rms_entry(f"rmsnorm_{tag}_m{m}_d{d}", gen, cfg,
                                     m, d, n, plus_one=plus_one))
        for kv, prun in sorted(run.get("paged", {}).items()):
            q8 = kv == "int8"
            for kind in ("prefill", "decode"):
                kname = f"paged_{kind}_attention"
                for b, s, ends in top_shapes(prun["tally"][kname]):
                    entries.append(paged_entry(
                        f"{kname}_{tag}_{kv}_d{cfg.hd}_b{b}_s{s}"
                        f"_kv{max(ends)}", kind,
                        gen, cfg.n_heads, cfg.n_kv_heads, cfg.hd, b, s,
                        ends, q8, bf, prun["tally"][kname][(b, s, ends)]))
    off = "none (not a main-path shape)"
    mis = get_config("mistral-nemo-12b")
    flash_entry("flash_attention_bf16_d96_s512", gen, dataclasses.replace(
        mis, head_dim=96), bf, "bhtd", 512, 528, off)
    return entries


# ---------------------------------------------------------------------------
# phase 4d: the dense matmul kernels against their plain versions
# ---------------------------------------------------------------------------

def tf32(t):
    """t with the low 13 bits of each fp32 mantissa cleared: TF32's 10."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def library_addmm(x, w, b, act, want, limit):
    """The library yardstick: ``torch._addmm_activation``, act(b + x @ w)
    in one cuBLASLt call, for ReLU or (``use_gelu``, its tanh form) GELU
    with a bias; for the squared ReLU without a bias (no single call
    computes it) ``torch.matmul`` and the activation after it; None for
    another function or where it lies beyond the limit."""
    if act == "relu2" and b is None:
        name = "matmul + relu2"

        def call():
            return torch.square(torch.relu(torch.matmul(x, w)))
    elif b is not None and act in ("relu", "gelu"):
        name, gelu = "addmm_activation", act == "gelu"

        def call():
            return torch._addmm_activation(b, x, w, use_gelu=gelu)
    else:
        return None
    err, ratio = excess(call(), want, limit)
    log(f"library {name}: max_abs_err={err:.3e} worst "
        f"err/limit={ratio:.3f}")
    if ratio > 1.0:
        log(f"library {name}: disagrees; not used")
        return None
    return call


def matmul_design(dtype, m, k, gated):
    """The route of ``csrc/hete_matmul.cu`` that a call takes (its
    ``dispatch``): bf16 at 48 rows or fewer the split-K weight stream or,
    gated, ``mma.sync`` tiles; above them the folded wgmma kernel or,
    gated, the unfolded two-weight wgmma kernel; fp32 the CUDA-core SGEMM,
    or at 8 rows or fewer the weight stream."""
    if dtype == torch.float32:
        return "simt_stream" if m <= 8 else "simt_tiled"
    if m <= 48:
        return "mma_sync" if gated else "splitk_stream"
    return "wgmma" if gated else "wgmma_fold"


def mm_entry(name, gen, dtype, m, k, n, launches, *, gated, act,
             bias=False):
    """One shape of ``matmul`` or ``gated_matmul`` on random operands at
    the model's scale (x ~ N(0, 1), weights ~ N(0, 1/K), bias ~ N(0, 1)):
    within its per-element limit, the limit shown to reject a sum missing
    its last 128-wide K block and a result without its bias (or, gated,
    the activation on the up product), and in fp32 the products of
    operands rounded to TF32; timed beside its plain version, one
    ``torch.matmul`` of the same product with no epilogue (for the gated
    kernel over both weights side by side; ``product_ms``), the library
    call (:func:`library_addmm`, ``matmul`` only) and the bound.  In
    fp32 it also logs how far the kernel's sum x @ w lies from cuBLAS's in
    units of ``ref._product_bound``, which set ``ref._MM_UNITS``."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    ws = [(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5)
          .to(dtype) for _ in range(2 if gated else 1)]
    b = torch.randn(n, generator=gen, device="cuda").to(dtype) \
        if bias else None
    f32 = dtype == torch.float32
    tag = f"{name}, "
    if gated:
        def kernel():
            return k_mm.gated_matmul(x, *ws, activation=act)

        def plain(xx=x, wg=ws[0], wu=ws[1]):
            return ref.gated_matmul(xx, wg, wu, activation=act)
        want = plain()
        limit = ref.gated_matmul_limit(x, *ws, want, activation=act)
        rejects(plain(x, ws[1], ws[0]), want, limit,
                tag + "the activation on the up product")
        short = plain(x[:, :-128], ws[0][:-128], ws[1][:-128])
        if f32:
            rejects(plain(tf32(x), tf32(ws[0]), tf32(ws[1])), want, limit,
                    tag + "operands rounded to TF32")
        wcat = torch.cat(ws, dim=1)
        library = None
    else:
        def kernel():
            return k_mm.matmul(x, ws[0], b, activation=act)

        def plain(xx=x, w=ws[0], bb=b):
            return ref.matmul(xx, w, bb, activation=act)
        want = plain()
        limit = ref.matmul_limit(x, ws[0], want, b, activation=act)
        if bias:
            rejects(plain(bb=None), want, limit,
                    tag + "a result without its bias")
        short = plain(x[:, :-128], ws[0][:-128])
        if f32:
            rejects(plain(tf32(x), tf32(ws[0])), want, limit,
                    tag + "operands rounded to TF32")
        wcat = ws[0]
        library = library_addmm(x, ws[0], b, act, want, limit)
    rejects(short, want, limit, tag + "a sum missing its last K block")
    if f32:
        z, zlim = ref._product_bound(x, ws[0])
        units = float(((k_mm.matmul(x, ws[0]) - z).abs()
                       / (zlim / ref._MM_UNITS)).max())
        log(f"kernel {name}: its fp32 sum lies {units:.3f} units from "
            f"cuBLAS's (the limit allows {ref._MM_UNITS})")
    got = kernel()
    check(torch.equal(kernel(), got), f"{name}: two calls differ")
    el = x.element_size()
    nbytes = (x.numel() + sum(w.numel() for w in ws) + m * n
              + (n if bias else 0)) * el
    flops = 2 * m * k * n * len(ws)
    entry = kernel_entry(
        name, "src/repro_torch/csrc/hete_matmul.cu",
        "src/repro/kernels/hete_matmul.py:" + ("126" if gated else "79"),
        launches, got, want, limit, kernel, plain, library, nbytes, flops,
        BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
    entry["product_ms"] = time_ms(lambda: torch.matmul(x, wcat))
    entry["design"] = matmul_design(dtype, m, k, gated)
    log(f"kernel {name}: product_ms={entry['product_ms']:.4f} "
        f"(torch.matmul of the same product, no epilogue), design "
        f"{entry['design']}")
    return entry


def check_matmul_kernels(counts_3b, counts_3f):
    """Phase 4d: ``matmul`` at 3f's two shapes (OPT fc1, fp32, bias +
    ReLU) and ``gated_matmul`` at 3b's two and two of 3e's prefill shapes
    (Mistral's gate/up, bf16, SiLU), in the ``kernels`` line; one shape
    off the main path each (bf16 ``matmul`` with bias and GELU, fp32
    ``gated_matmul``, at sizes that are no multiple of 128), logged only."""
    gen = torch.Generator(device="cuda").manual_seed(2468)
    opt, mis = get_config("opt-6.7b"), get_config("mistral-nemo-12b")
    f32, bf = torch.float32, torch.bfloat16
    fc1 = counts_3f["matmul_rows"]
    gate = counts_3b["bf16_gated_rows"]
    gate_3e = counts_3b["3e"]["bf16_gated_rows"]
    b = 4
    entries = []
    for rows in (b * OFFLOAD_PROMPT, b):
        entries.append(mm_entry(
            f"matmul_f32_m{rows}", gen, f32, rows, opt.d_model, opt.d_ff,
            fc1.get((rows, opt.d_model), 0), gated=False, act="relu",
            bias=True))
    for rows, n in ((b * ONESHOT_PROMPT, gate), (b, gate),
                    (PAGED_PROMPTS[0], gate_3e),
                    (PAGED_PROMPTS[-1], gate_3e)):
        entries.append(mm_entry(
            f"gated_matmul_bf16_m{rows}_"
            + matmul_design(bf, rows, mis.d_model, True), gen, bf, rows,
            mis.d_model,
            mis.d_ff, n.get((rows, mis.d_model), 0), gated=True,
            act="silu"))
    off = "none (not a main-path shape)"
    mm_entry("matmul_bf16_m37_splitk_stream", gen, bf, 37, 1000, 3000, off,
             gated=False, act="gelu", bias=True)
    mm_entry("gated_matmul_bf16_m130_18432x2048_wgmma", gen, bf, 130,
             18432, 2048, off, gated=True, act="silu")
    mm_entry("gated_matmul_f32_m130", gen, f32, 130, 2000, 3000, off,
             gated=True, act="silu")
    return entries


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 3k: training
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    """(key path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _perturbed(params, seed):
    """Draw the leaves that start at zero and would hide a mechanism
    (Gemma's (1+w) norm scales, Zamba2's LoRA ``b``)."""
    gen = torch.Generator().manual_seed(seed)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        norm = path[-1] == "scale" and not bool(t.any())
        if norm or path[-2:] == ("shared_lora", "b"):
            r = torch.randn(t.shape, generator=gen)
            return (r * (0.2 if norm else 0.05)).to(t.dtype)
        return t
    return walk(params, ())


def train_batch(cfg, b, s, seed):
    """Next-token labels over seeded tokens; the VLM's patch embeddings in
    place of the tokens and the encoder-decoder's frames beside them, as
    ``configs.shapes.input_specs`` lays a train batch out."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"labels": t[:, 1:]}
    if cfg.embeds_input:
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    else:
        batch["tokens"] = t[:, :-1]
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def check_no_launches(run):
    counts = ops.launch_counts()
    check(not any(counts.values()),
          f"{run}: training launched a kernel or a counted plain branch: "
          f"{ {k: v for k, v in counts.items() if v} }")


def check_guard_on_card():
    """A kernel wrapper refuses, on the card, an input that requires grad
    under grad mode, before it launches; under ``no_grad`` it launches."""
    x = torch.randn(4, 64, device="cuda")
    w = torch.ones(64, device="cuda", requires_grad=True)
    ops.reset_launch_counts()
    try:
        ops.rmsnorm(x, w)
    except RuntimeError as e:
        check("no backward" in str(e), f"guard message: {e}")
        log(f"3k guard: {e}")
    else:
        raise SystemExit("FAILED: rmsnorm launched under grad mode on an "
                         "input that requires grad")
    check(ops.launch_counts()["rmsnorm"] == 0, "the guard let rmsnorm launch")
    with torch.no_grad():
        ops.rmsnorm(x, w)
    check(ops.launch_counts()["rmsnorm"] == 1, "rmsnorm under no_grad")


def run_train_families(seed):
    """3k(a): one ``loss_and_grads`` and one train step of each reduced
    family on the card and on the CPU, from the same state and batch."""
    for name in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_config(name)
        if name != "tiny":
            cfg = reduced(cfg)
        tcfg = TL.TrainConfig(optimizer=OptimizerConfig(name=cfg.optimizer,
                                                        lr=1e-2),
                              warmup=2, total_steps=10)
        step, opt_init = TL.make_train_step(cfg, tcfg)
        params = _perturbed(M.init_params(cfg, seed, device="cpu"), seed)
        host = {"params": params, "opt": opt_init(params),
                "step": torch.zeros((), dtype=torch.int32)}
        card = M.tree_to(host, "cuda")
        batch = train_batch(cfg, 2, TRAIN_SMALL_SEQ, seed)
        out = {}
        for dev, state in (("cpu", host), ("cuda", card)):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            ops.reset_launch_counts()
            loss, met, grads = TL.loss_and_grads(cfg, state["params"], tb)
            _, m = step(state, batch)
            if dev == "cuda":
                torch.cuda.synchronize()
                check_no_launches(f"3k {name}")
            out[dev] = (float(loss), float(met["aux"]), float(m["loss"]),
                        _paths(grads))
        (l_h, a_h, s_h, g_h), (l_d, a_d, s_d, g_d) = out["cpu"], out["cuda"]
        for what, h, d in (("loss", l_h, l_d), ("aux", a_h, a_d),
                           ("step loss", s_h, s_d)):
            check(abs(d - h) <= TRAIN_LOSS_TOL * abs(h),
                  f"3k {name}: {what} card {d} cpu {h}")
        top = max(float(g.abs().max()) for _, g in g_h if g is not None)
        worst = 0.0
        for (path, gh), (_, gd) in zip(g_h, g_d):
            if path == ("embed",) and cfg.embeds_input:
                # patch embeddings feed the trunk: the loss never reaches
                # the token table, on either device
                check(gh is None and gd is None,
                      f"3k {name}: a gradient for the unused token table")
                continue
            check(gh is not None and gd is not None,
                  f"3k {name}: no gradient for {path}")
            gd = gd.cpu()
            check(bool(torch.isfinite(gd).all()),
                  f"3k {name}: non-finite gradient in {path}")
            if path[-1] == "bk":        # q . bk shifts a row: exact grad 0
                check(max(float(gh.abs().max()), float(gd.abs().max()))
                      <= 1e-5 * top, f"3k {name}: key bias gradient")
                continue
            scale = float(gh.abs().max())
            err = float((gd - gh).abs().max())
            check(err <= TRAIN_GRAD_TOL * scale,
                  f"3k {name}: {path} gradient card-cpu {err:.3e} over "
                  f"{TRAIN_GRAD_TOL} of {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
        log(f"3k {name}: {len(g_h)} leaves, loss card {l_d:.6f} cpu "
            f"{l_h:.6f}, aux {a_d:.6f}, step loss {s_d:.6f}, worst leaf "
            f"gradient error {worst:.3e} of its max |g|, optimizer "
            f"{cfg.optimizer}, launches 0, {time.perf_counter() - t0:.1f} s")
        del host, card


def train_flops(cfg, n_params, tokens, n_seq, seq):
    """Model FLOPs of one optimizer step: 6 N per token, the attention's
    12 L S^2 d_head heads per sequence, times 4/3 under remat."""
    attn = 12 * cfg.n_layers * seq * seq * cfg.hd * cfg.n_heads * n_seq
    return (6 * n_params * tokens + attn) * (4 / 3 if cfg.remat else 1)


def run_gemma_training(seed, smi):
    """3k(b): Gemma-2-2B whole, trained ``TRAIN_STEPS`` steps on the card."""
    cfg = get_config("gemma2-2b")
    tcfg = TL.TrainConfig(accum_steps=TRAIN_ACCUM,
                          optimizer=OptimizerConfig(name="adamw", lr=TRAIN_LR),
                          warmup=1, total_steps=100)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step, opt_init = TL.make_train_step(cfg, tcfg)
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), device="cuda")
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    start = [(path, p.to("cpu", copy=True)) for path, p in _paths(params)]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in _paths(params))
    log(f"3k gemma2-2b: {cfg.n_layers} layers d={cfg.d_model} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} ffn={cfg.d_ff} vocab="
        f"{cfg.vocab_size} window={cfg.window} softcaps="
        f"{cfg.attn_softcap}/{cfg.logit_softcap} {cfg.dtype} remat="
        f"{cfg.remat}, {n_params} params, init {time.perf_counter() - t0:.1f}"
        f" s; B 1 x S {TRAIN_SEQ} x {TRAIN_ACCUM} microbatches, AdamW fp32 "
        f"moments, lr {TRAIN_LR}")
    data = make_training_data(cfg, batch=TRAIN_ACCUM, seq=TRAIN_SEQ,
                              seed=seed)
    tokens = TRAIN_ACCUM * TRAIN_SEQ
    flops = train_flops(cfg, n_params, tokens, TRAIN_ACCUM, TRAIN_SEQ)
    times = []
    for i in range(TRAIN_STEPS):
        batch = next(data)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        check_no_launches(f"3k gemma2-2b step {i + 1}")
        check(math.isfinite(loss), f"3k gemma2-2b: step {i + 1} loss {loss}")
        if i == 0:
            same = [path for (path, p0), (_, p) in zip(start, _paths(
                state["params"])) if torch.equal(p0, p.cpu())]
            check(not same, f"3k gemma2-2b: leaves unchanged by step 1: "
                            f"{same[:5]} ({len(same)})")
            del start
        log(f"3k gemma2-2b step {i + 1}: loss {loss:.4f} (nll "
            f"{float(m['nll']):.4f}, lr {float(m['lr']):.3e}), {dt:.3f} s, "
            f"{tokens / dt:.1f} tokens/s, {flops / dt / 1e12:.1f} model "
            f"TFLOP/s = {flops / dt / BF16_FLOPS:.4f} of BF16_FLOPS")
    data.close()
    peak = torch.cuda.max_memory_allocated() - base
    pbytes = 2 * n_params
    logits = TRAIN_SEQ * cfg.vocab_size * 4
    reckoned = 2 * pbytes + 2 * 4 * n_params + 4 * n_params + 4 * logits
    steady = sorted(times[1:])[len(times[1:]) // 2] if len(times) > 1 \
        else times[0]
    log(f"3k gemma2-2b on {smi}: {TRAIN_STEPS} steps, s per step "
        f"{[round(t, 3) for t in times]} (steady {steady:.3f}), "
        f"{tokens / steady:.1f} tokens/s, model FLOP/s share "
        f"{flops / steady / BF16_FLOPS:.4f}, peak memory "
        f"{peak / 2**30:.2f} GiB against a reckoning of "
        f"{reckoned / 2**30:.2f} GiB (bf16 params and grads, fp32 m, v and "
        f"accumulation buffer, four fp32 logit-sized buffers)")
    del state, params
    torch.cuda.empty_cache()


def run_trainer_resume(seed):
    """3k(c): ``tiny`` under ``Trainer`` on the card, interrupted and
    resumed against uninterrupted; a bf16 state's checkpoint round trip."""
    cfg = get_config("tiny")
    tcfg = TL.TrainConfig(optimizer=OptimizerConfig(lr=1e-2), warmup=2)
    root = os.path.join(OUT_DIR, f"train_ckpt_{os.getpid()}")

    def batches():
        r = np.random.default_rng(seed + 7)
        while True:
            t = r.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
            yield {"tokens": t[:, :-1], "labels": t[:, 1:]}

    ops.reset_launch_counts()
    t_all = TL.Trainer(cfg, tcfg, checkpoint_dir=os.path.join(root, "a"),
                       checkpoint_every=3, async_checkpoint=False, seed=seed)
    t_all.run(batches(), 6)
    t1 = TL.Trainer(cfg, tcfg, checkpoint_dir=os.path.join(root, "b"),
                    checkpoint_every=3, async_checkpoint=False, seed=seed)
    gen = batches()
    t1.run(gen, 3)
    del t1
    t2 = TL.Trainer(cfg, tcfg, checkpoint_dir=os.path.join(root, "b"),
                    checkpoint_every=3, async_checkpoint=True, seed=seed)
    check(t2.step == 3, f"3k resume: restored step {t2.step}")
    t2.run(gen, 3)
    check_no_launches("3k resume")
    worst = 0.0
    for (path, a), (_, b) in zip(_paths(t_all.state["params"]),
                                 _paths(t2.state["params"])):
        check(a.device.type == "cuda", "3k resume: params left the card")
        err = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, rtol=1e-6, atol=1e-6)),
              f"3k resume: {path} differs by {err:.3e}")
        worst = max(worst, err)
    log(f"3k resume: 6 steps against 3 + restore + 3 on the card, losses "
        f"{[round(m['loss'], 4) for m in t_all.metrics_log]} / "
        f"{[round(m['loss'], 4) for m in t2.metrics_log]} (resumed part), "
        f"largest param difference {worst:.3e}")
    gen_ = torch.Generator(device="cuda").manual_seed(seed)
    st = {"w": torch.randn(64, 48, generator=gen_, device="cuda")
          .to(torch.bfloat16),
          "m": torch.randn(48, generator=gen_, device="cuda"),
          "step": torch.tensor(9, dtype=torch.int32, device="cuda")}
    mgr = CheckpointManager(os.path.join(root, "bf16"), async_save=True)
    mgr.save(9, st)
    mgr.wait()
    back = mgr.restore(9, {k: torch.zeros_like(v) for k, v in st.items()})
    for k, v in st.items():
        b = back[k]
        check(b.device.type == "cuda" and b.dtype == v.dtype,
              f"3k bf16 checkpoint: {k} restored as {b.dtype} on "
              f"{b.device}")
        bits = (lambda t: t.view(torch.int16)) if v.dtype == torch.bfloat16 \
            else (lambda t: t)
        check(torch.equal(bits(b), bits(v)),
              f"3k bf16 checkpoint: {k} not bit-identical")
    log("3k bf16 checkpoint: saved and restored on the card bit for bit")


def run_train_launcher():
    """3k(d): the training launcher as a subprocess on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "tiny", "--steps", "40"], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    for line in out.stdout.splitlines():
        log(f"3k launcher: {line}")
    check(out.returncode == 0,
          f"3k launcher exited {out.returncode}: {out.stderr[-2000:]}")
    done = [line.split() for line in out.stdout.splitlines()
            if line.startswith("done: loss")]
    check(len(done) == 1, "3k launcher: no 'done' line")
    first, last = float(done[0][2]), float(done[0][4])
    check("device cuda" in out.stdout, "3k launcher did not run on cuda")
    check(last < first, f"3k launcher: loss {first} -> {last} did not fall")


def run_training(seed, smi):
    """Phase 3k."""
    check_guard_on_card()
    timed("3k(a)", run_train_families, seed)
    timed("3k(b)", run_gemma_training, seed, smi)
    timed("3k(c)", run_trainer_resume, seed)
    timed("3k(d)", run_train_launcher)


def sim_decode_modules(cfg, batch, ctx, by=4):
    """``core.sim`` modules of one decode step of a dense decoder, as the
    JAX package's benchmarks build OPT's: per layer q, k, v, o, fc1 and fc2
    linears of ``by`` bytes a weight (4: cell 3's fp32 wire) and the
    attention core over ``ctx`` cached positions."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def linear(name, n_in, n_out, group):
        return sim.SimModule(name, "linear", n_in * n_out * by, n_out, group,
                             2 * batch * n_in * n_out)

    mods = []
    for l in range(cfg.n_layers):
        mods += [linear(f"l{l}.wq", d, hq * hd, "attn"),
                 linear(f"l{l}.wk", d, hkv * hd, "attn"),
                 linear(f"l{l}.wv", d, hkv * hd, "attn"),
                 sim.SimModule(f"l{l}.attn", "attn_core", 0, 0, "attn",
                               4 * batch * d * ctx,
                               cache_bytes=2 * batch * hkv * hd * ctx * by),
                 linear(f"l{l}.wo", hq * hd, d, "attn"),
                 linear(f"l{l}.w_in", d, f, "mlp"),
                 linear(f"l{l}.w_down", f, d, "mlp_down")]
    return mods


def log_sim_prediction(full, fit, stats, layers, prompts):
    """The simulator's decode prediction for cell 3's fp run over the
    fitted host spec, beside the run's measured tok/s (a log line)."""
    hw = dataclasses.replace(H100_HOST, **fit)
    ctx = int(np.mean([len(p) for p in prompts])) + MAX_NEW // 2
    mods = sim_decode_modules(full, 4, ctx)
    r = sim.run_strategy(mods, "hetegen", hw, batch=4)
    pl = sim.make_placements(mods, "hetegen", hw, batch=4)
    alpha = next(p.alpha for p in pl.values() if p.mode == "hetegen")
    util = " ".join(f"{k}={v:.4f}" for k, v in sorted(r.utilization.items()))
    log(f"cell 3 sim (OPT-6.7B {full.n_layers} layers, fp32 wire, decode "
        f"batch 4, context {ctx}, fitted H100_HOST): step {r.step_time:.4f}"
        f" s, {r.throughput(4):.3f} tok/s, alpha {alpha:.4f}, utilization "
        f"{util}; measured ({layers} layers, prefill and decode): "
        f"{stats['tokens_per_s']:.3f} tok/s, {stats['steps']} steps, "
        f"phase alpha {stats['phase_alpha']}")


# ---------------------------------------------------------------------------
# Phase 3m: the sharded path
# ---------------------------------------------------------------------------

SHARD_PROMPT = 512                 # 3m(a): prompt tokens per row
SHARD_NEW = 16                     # 3m(a): serve steps
SHARD_CELLS = ("mistral-nemo-12b", "nemotron-4-340b")   # 3m(b), decode_32k
LSE_TOL = 1e-3                     # 3m(a): |kernel - plain| log-sum-exp


def _shard_part(part: str, timeout: int = 600) -> dict:
    """Run ``chip_smoke.py --part <part>`` in a process of its own (a
    process has one default group) and return the JSON it prints last; a
    failing part fails the script."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--part", part], env=env, cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    for line in out.stdout.splitlines()[:-1]:
        log(f"{part}: {line}")
    check(out.returncode == 0,
          f"{part} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.splitlines()[-1])


def part_world1() -> dict:
    """3m(a), in its own process: an NCCL world of one rank on a (1, 1)
    ("data", "model") mesh.  Mistral-NeMo-12B at full width and depth,
    its weights placed by ``param_specs`` (on one rank each local shard is
    the whole tensor: no copy), through ``make_prefill_step`` over 4 x 512
    tokens and ``SHARD_NEW`` ``make_serve_step``s under
    ``ShardingRules.for_mesh``, then the same steps with ``NO_RULES`` on
    the same weights: logits the same bits, greedy tokens equal, the
    kernels launched through ``local_map`` as many times as unsharded.
    Also ``compressed_psum_mean`` over NCCL against dequantize(quantize(x))
    and the decode kernel's log-sum-exp against its plain version."""
    import torch.distributed as dist

    from repro_torch.distributed import compression as DC
    from repro_torch.distributed import specs as DS
    from repro_torch.distributed.shardings import NO_RULES, ShardingRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import engine as E

    torch.cuda.set_device(0)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, f"pg_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rules = ShardingRules.for_mesh(mesh)
        cfg = get_config("mistral-nemo-12b")
        params = M.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(SEED), device="cuda")
        whole = lambda path, leaf, shape: leaf        # noqa: E731
        dparams = DS.distribute(params, mesh, DS.param_specs(
            cfg, rules, serve=True), local_fn=whole)
        rng = np.random.default_rng(SEED)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, SHARD_PROMPT)).astype(np.int32)).cuda()
        seen = []
        greedy = E._greedy

        def record(logits, r):
            seen.append(logits.full_tensor() if hasattr(logits,
                                                        "full_tensor")
                        else logits)
            return greedy(logits, r)

        E._greedy = record
        runs = {}
        for name, r in (("rules", rules), ("none", NO_RULES)):
            cache = M.init_cache(cfg, 4, SHARD_PROMPT + SHARD_NEW,
                                 device="cuda")
            p, batch = params, {"tokens": toks}
            if r is rules:
                cache = DS.distribute(cache, mesh, DS.cache_specs(
                    cfg, rules, cache), local_fn=whole)
                p = dparams
                batch = DS.distribute(batch, mesh, DS.batch_specs(
                    cfg, rules, batch), local_fn=whole)
            pre, serve = E.make_prefill_step(cfg, r), E.make_serve_step(cfg, r)
            seen.clear()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            cache, tok = pre(p, batch, cache)
            out = [tok]
            for _ in range(SHARD_NEW):
                cache, tok = serve(p, tok, cache)
                out.append(tok)
            torch.cuda.synchronize()
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            runs[name] = dict(
                s=time.perf_counter() - t0, launches=launches,
                logits=list(seen),
                tokens=[(t.full_tensor() if hasattr(t, "full_tensor")
                         else t).tolist() for t in out])
        E._greedy = greedy
        a, b = runs["rules"], runs["none"]
        check(len(a["logits"]) == len(b["logits"]) == SHARD_NEW + 1,
              "3m(a): not every step's logits were seen")
        same = [torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])]
        worst = max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(a["logits"], b["logits"]))
        check(all(same), f"3m(a): logits differ with rules (max |diff| "
              f"{worst}, steps equal {same})")
        check(a["tokens"] == b["tokens"], "3m(a): greedy tokens differ")
        check(a["launches"] == b["launches"],
              f"3m(a): launches {a['launches']} with rules, "
              f"{b['launches']} without")
        for k in ("gated_matmul", "rmsnorm", "flash_attention",
                  "decode_attention"):
            check(a["launches"].get(k, 0) > 0, f"3m(a): {k} never launched")

        x = torch.randn(3, 1 << 20, device="cuda")
        got = DC.compressed_psum_mean(x, mesh.get_group("data"))
        q, sc, shp = DC.quantize_int8(x)
        check(torch.equal(got, DC.dequantize_int8(q, sc, shp)),
              "3m(a): compressed_psum_mean over NCCL != dequantize(quantize)")

        lse_err = {}
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(7)
            qd = torch.randn(8, cfg.n_heads, cfg.hd, generator=g,
                             device="cuda").to(dt)
            kd = torch.randn(8, cfg.n_kv_heads, 2048, cfg.hd, generator=g,
                             device="cuda").to(dt)
            vd = torch.randn(8, cfg.n_kv_heads, 2048, cfg.hd, generator=g,
                             device="cuda").to(dt)
            lens = torch.tensor([2048, 2047, 1500, 1024, 511, 64, 1, 0],
                                dtype=torch.int32, device="cuda")
            _, lk = ops.decode_attention(qd, kd, vd, lens, return_lse=True)
            _, lp = ref.decode_attention(qd, kd, vd, lens, return_lse=True)
            fin = torch.isfinite(lp)
            check(torch.equal(fin, torch.isfinite(lk)),
                  f"3m(a): {dt} lse is -inf on other rows than the plain's")
            lse_err[str(dt)] = float((lk[fin] - lp[fin]).abs().max())
            check(lse_err[str(dt)] <= LSE_TOL,
                  f"3m(a): {dt} decode lse off by {lse_err[str(dt)]}")
        return {"launches": a["launches"], "rules_s": a["s"],
                "none_s": b["s"], "lse_err": lse_err,
                "tokens_row0": a["tokens"][1][0]}
    finally:
        dist.destroy_process_group()


def part_dryrun() -> dict:
    """3m(b), in its own process: ``run_cell`` with ``device="cuda"`` on
    rank 0 of a fake 256-rank world (collectives move no data), for each
    of ``SHARD_CELLS`` x decode_32k x single."""
    from repro_torch.launch import dryrun as DR
    out = {}
    for arch in SHARD_CELLS:
        rec = DR.run_cell(arch, "decode_32k", "single", device="cuda",
                          verbose=False)
        check(rec["status"] == "ok",
              f"3m(b) {arch}: {rec.get('error')} {rec.get('traceback')}")
        out[arch] = {k: rec[k] for k in ("memory", "hlo", "roofline",
                                         "step_ms", "trace_s", "launches",
                                         "kernel_calls")}
    return out


def run_sharded(smi):
    """Phase 3m: the sharded path (:func:`part_world1`,
    :func:`part_dryrun`)."""
    a = timed("3m(a)", _shard_part, "3m_world1")
    log(f"3m(a) mistral-nemo-12b (1, 1) mesh: launches {a['launches']}, "
        f"prefill {SHARD_PROMPT} + {SHARD_NEW} steps in {a['rules_s']:.2f} s "
        f"with rules, {a['none_s']:.2f} s without; logits the same bits; "
        f"decode lse max |kernel - plain| {a['lse_err']}")
    b = timed("3m(b)", _shard_part, "3m_dryrun")
    gib = 2 ** 30
    for arch, rec in b.items():
        mem, hlo = rec["memory"], rec["hlo"]
        an = mem["analytic"]
        check(mem["argument_bytes"] == an["params"] + an["cache"],
              f"3m(b) {arch}: argument bytes {mem['argument_bytes']} != "
              f"analytic params + cache {an['params'] + an['cache']}")
        log(f"3m(b) {arch} decode_32k rank 0 of (16, 16) on {smi}: "
            f"argument_bytes {mem['argument_bytes']} "
            f"({mem['argument_bytes'] / gib:.3f} GiB) = analytic params "
            f"{an['params']:.0f} + cache {an['cache']:.0f}; measured peak "
            f"{mem['measured_peak_bytes']} ({mem['measured_peak_bytes'] / gib:.3f}"
            f" GiB) against analytic total {an['total']:.0f} "
            f"({an['total'] / gib:.3f} GiB), ratio "
            f"{mem['measured_peak_bytes'] / an['total']:.4f}; card memory "
            f"{mem['device_total_bytes']}")
        log(f"3m(b) {arch}: flops/device {hlo['flops_per_device']:.6e} "
            f"bytes/device {hlo['bytes_per_device']:.6e} collective wire "
            f"bytes {hlo['collective_bytes']} ({hlo['collective_count']} "
            f"collectives); roofline {rec['roofline']}; step "
            f"{rec['step_ms']:.3f} ms (traced once in {rec['trace_s']} s); "
            f"launches {rec['launches']}")
    return a, b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of OPT-6.7B to run (of 32), "
                         "phases 3 and 3c")
    ap.add_argument("--part", choices=("3m_world1", "3m_dryrun"),
                    default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if args.part:
        torch.backends.cuda.matmul.allow_tf32 = False
        out = {"3m_world1": part_world1, "3m_dryrun": part_dryrun}[
            args.part]()
        print(json.dumps(out), flush=True)
        return 0
    # fp32 everywhere: no TF32 in matmuls, so the plain versions and the
    # ResidentBackend reference are full-precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = kbuild.build()
    for name, out in logs.items():
        summary = " | ".join(line.strip() for line in out.splitlines()
                             if "registers" in line or "Compiling" in line)
        log(f"build {name}: {summary}")
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} kernels")
    check_sass()

    full = get_config("opt-6.7b")
    check(1 <= args.layers <= full.n_layers, "bad --layers")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    log(f"model: opt-6.7b at full width, {cfg.n_layers} of "
        f"{full.n_layers} layers, d={cfg.d_model} heads={cfg.n_heads} "
        f"ffn={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype}")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED), device="cuda")
    host_params = M.tree_to(params, "cpu")
    torch.cuda.synchronize()
    log(f"init: {time.perf_counter() - t0:.1f} s")
    prompts = make_prompts(cfg.vocab_size, SEED)

    compare_prefill_logits(cfg, params, host_params, prompts)
    oprompts = offload_prompts(cfg.vocab_size, SEED)
    hetegen_logits = compare_dense_prefill_logits(cfg, params, host_params,
                                                  oprompts)
    counts_3f = timed("3f", run_opt_resident, cfg, params, oprompts,
                      hetegen_logits)
    del params
    torch.cuda.empty_cache()

    paged = ("paged_prefill_attention", "paged_decode_attention")
    keys = {name: paged_key for name in paged}
    (_, l_fp, st_fp, fp_spans), fp_tally = tally_rows(
        lambda: run_main_path(cfg, host_params, prompts, wstream="fp",
                              kv_dtype=None), paged, keys)
    keys["q8_matmul"] = lambda x, q, *_, **__: (*x.shape, q.shape[1])
    (_, l_q8, _, _), q8_tally = tally_rows(
        lambda: run_main_path(cfg, host_params, prompts, wstream="q8",
                              kv_dtype="int8"), ("q8_matmul", *paged), keys)
    q8_shapes = q8_tally["q8_matmul"]
    log(f"q8 run: q8_matmul launches by (M, K, N) {q8_shapes}")
    paged_shapes = {}
    for name in paged:
        kind = name.split("_")[1]
        paged_shapes[kind] = {False: fp_tally[name], True: q8_tally[name]}
        for run, counts, tally in (("fp", l_fp, fp_tally),
                                   ("q8", l_q8, q8_tally)):
            log(f"{run} run: {name} launches by (B, S, kv ends) "
                f"{tally[name]}")
            check(sum(tally[name].values()) == counts[name],
                  f"{run} run: {name} calls by shape do not add up to its "
                  f"launches")
    for run, counts in (("fp", l_fp), ("q8", l_q8)):
        check(counts["paged_decode_attention"] > 0,
              f"{run} run never launched paged_decode_attention")
        check(counts["paged_prefill_attention"] > 0,
              f"{run} run never launched paged_prefill_attention")
    check(l_q8["q8_matmul"] > 0, "q8 run never launched q8_matmul")
    check(sum(q8_shapes.values()) == l_q8["q8_matmul"],
          "q8 run: q8_matmul calls by shape do not add up to its launches")
    for run, counts in (("fp", l_fp), ("q8", l_q8)):
        check(counts["matmul"] == counts["gated_matmul"] == 0,
              f"{run} run launched a matmul kernel on the HeteGen split")
    launches = {
        "paged_decode_attention": {False: l_fp["paged_decode_attention"],
                                   True: l_q8["paged_decode_attention"]},
        "paged_prefill_attention": {False: l_fp["paged_prefill_attention"],
                                    True: l_q8["paged_prefill_attention"]},
    }

    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    fit = fit_host_spec(cfg, fp_spans, smi)
    del fp_spans
    log_sim_prediction(full, fit, st_fp, cfg.n_layers, prompts)
    timed("3g", run_recalibration, dataclasses.replace(
        cfg, n_layers=min(RECAL_LAYERS, cfg.n_layers)), host_params)
    verify_fp = timed("3i", run_speculative, cfg, host_params)
    counts_3b = timed("3b+3e", run_mistral, SEED)
    counts_3c = timed("3c", run_offload_oneshot, cfg, host_params, oprompts)
    counts_3d = timed("3d", run_mamba, SEED)
    runs_3j = timed("3j", run_families, SEED)
    runs_3l = timed("3l", run_new_archs, SEED)
    timed("3k", run_training, SEED, smi)
    timed("3m", run_sharded, smi)
    for kind in ("paged_decode_attention", "paged_prefill_attention"):
        launches[kind + "_3e"] = {kv: counts_3b["3e"][kv][kind]
                                  for kv in ("bf16", "int8")}

    entries = timed("4", check_kernels, cfg, launches, q8_shapes,
                    paged_shapes)
    entries += timed("4v", check_verify_shapes, cfg, verify_fp,
                     counts_3b["3i_bf16"])
    entries += timed("4b", check_dense_kernels,
                     get_config("mistral-nemo-12b"), cfg, counts_3b,
                     counts_3c)
    entries += timed("4c", check_ssd_kernel, counts_3d)
    entries += timed("4d", check_matmul_kernels, counts_3b, counts_3f)
    entries += timed("4j", check_family_kernels, runs_3j)
    entries += timed("4l", check_arch_kernels, runs_3l)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
