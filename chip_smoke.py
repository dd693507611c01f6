#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``styletts_zs_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. device     — requires CUDA; prints the card's name and power limit;
  2. build      — compiles ``styletts_zs_torch/csrc/*.cu``, one nvcc per
                  source, all started together (``-Xptxas -v`` register,
                  shared-memory and spill lines printed, and any wgmma
                  serialisation ptxas reports; for the kernels built on
                  ``sm90.cuh`` — rows 1 and 2 (``attention_fwd_sm90.cuh``;
                  row 2's fp32 kernel beside it), 4, 5, 6, 7, 10, 11 and
                  12 — their dynamic shared memory and blocks per SM);
  3. kernels    — each hand-written kernel against its plain PyTorch
                  version at the main paths' shapes, fp32 and bf16, masked
                  and unmasked, with kernel / plain / library times from
                  CUDA events and the bound computed from the inputs; the
                  AdaIN conv pass at every shape a path launches it
                  (long-form, the 1-step batch 32, serving's 512 and 256
                  buckets, the train step's forward), the transposed conv
                  and the synthesis head (through ``dispatch``, on the
                  vocoder's (B, C, T)-major view) at the long-form and the
                  1-step batch-32 shapes, chunk-local attention
                  also at 256 and 512 frames (the first through the
                  full-attention kernel), full attention in fp32 at the
                  denoiser's cross- and self-attention (both timed) and in
                  bf16 also at Tk 272 with the denoiser's mask and Tq 50
                  and 16, and
                  the cuDNN kernels that the library calls of the two convs
                  launch; rows 6, 7 and 10 also at the tensor-parallel
                  step's chunk shapes (512 -> 256 and 512 -> 128, row 6's
                  128-channel block beside the 256 one);
  4. main path  — zero-shot 1-step synthesis with the vocoder at full width
                  (``bench.py``'s configuration: 256 phonemes, 1024 frames,
                  bf16, weights from a seed) at batch 1 and 32, checking the
                  waveforms, the kernel launch counts per call, audio-s/s,
                  the real-time factor, peak memory, and the mel MAE against
                  the fp32 plain path on the CPU (also with the CPU's
                  durations fed in, with the card's and with the CPU's
                  style: duration flips against the kernels' drift);
  5. profile    — device time by kernel for one batch-32 1-step call;
  6. multi-step — acceptance config 3 (``configs/multistep_b32.toml``: batch
                  32, 16 Heun steps, guidance 3, mel without the vocoder) on
                  the same model: time per call, audio-s/s, peak memory, the
                  launches per call of every kernel, and the fp32 card path
                  against the fp32 CPU plain path at batch 1;
  7. profile    — the same breakdown for one multi-step batch-32 call;
  8. long-form  — acceptance level 4 (``configs/longform_60s.toml``: batch
                  4, 4864 frames = 60.8 s, 1-step, with the vocoder) and
                  its 2048-frame bucket: time per call, audio-s/s, peak
                  memory, the launches per call of every kernel, and the
                  fp32 card path against the fp32 CPU plain path at batch 1;
  9. profile    — the same breakdown for one long-form call;
 10. train_stage1 — the stage-1 acoustic GAN step (``Stage1Trainer``) at
                  batch 16 x 1024 frames, full width, bf16, dropout on: one
                  warm-up step, the median of 5, audio-s trained per s,
                  peak memory, the loss terms (finite), the launches per
                  step of every kernel (rows 3-5 and 7 in the backward)
                  and the twin backwards; then fp32 on the card against
                  fp32 on the CPU at batch 2 (FSQ codes and durations
                  equal, every loss term and gradient tensor within its
                  tolerance);
 11. profile    — the same breakdown for one train step;
 12. train_stage2 — the stage-2 style-diffusion step (``Stage2Trainer``) at
                  batch 16 x 1024 frames, the acoustic model frozen in bf16,
                  the denoiser fp32 (AdaLN gates drawn from a seed): one
                  warm-up step, the median of 5, audio-s trained per s,
                  peak memory, the loss, the launches per step and the twin
                  backwards; then fp32 on the card against fp32 on the CPU
                  at batch 2 on the same draws (the loss, every denoiser
                  gradient, the worst tensor printed);
 13. profile    — the same breakdown for one stage-2 step;
 14. train_stage3 — the stage-3 distillation step (``Stage3Trainer``: the
                  16-step teacher at guidance 3 under no_grad, the 1-step
                  student, both decoded through the frozen bf16 acoustic
                  model, the student's through rows 3-5 and 7 backward), the
                  same measures, rows 8-9 16 and 15 times a step; then fp32
                  card vs CPU at batch 2 with 4 teacher steps (both decodes'
                  durations equal, the loss terms and gradients gated);
 15. profile    — the same breakdown for one stage-3 step;
     corpus     — the corpus path at the same width: the port's native
                  frontend built and taken by ``estimate_f0`` (``featurize``
                  of one 1024-frame utterance timed on both F0 routes); a
                  48-utterance, 8-speaker corpus from
                  ``export_synthetic_corpus`` and a copy without durations;
                  MAS alone at 16 x 1024 x 256 (durations equal to the
                  CPU's, ms, launches); the stage-1 step with
                  ``use_mas_durations`` from the unannotated corpus (batches
                  of ``make_corpus_loader``, batch 16 x 1024, bf16, dropout
                  on: ms, loader ms a batch, peak memory, launches per step
                  as the stage-1 phase's plus the discriminator step's
                  aligner) and its fp32 card-vs-CPU check on the
                  train_stage1 phase's batch of 2 (two frame lengths; MAS
                  durations equal); the five evaluations of
                  ``pipelines/eval.py`` on a held-out batch of 16 (finite,
                  ms each) and at batch 2 in fp32 against the CPU (floats
                  within 1e-3, counts and rates equal); ``train --stage 1
                  --corpus --steps 2`` with MAS on, its ``stage1_final``
                  loaded back;
     pipeline   — ``run_pipeline`` (``pipelines/pipeline.py``, the three
                  stages with their gates, the bundle and a synthesis) at
                  full width (``Config()``, bf16 on fp32 masters, batch 16 x
                  256 frames), 2 steps a stage and a gate every step: each
                  step's ms and launches (as the stage's step predicts at
                  256 frames; rows 1, 3-5 and 11 at 0, no launch outside
                  the probed calls), each gate's and synthesis's ms, the
                  report's keys and finite numbers, peak memory; a second
                  call with ``--skip-stage1/2`` (stage 3 given the saved
                  trees bit for bit); level 5 from the bundle the card
                  trained;
 16. serve      — acceptance level 5 at full size (``Server``: batch 32,
                  buckets of 256, 512 and 1024 frames, 1-step, mel only,
                  bf16): 256 requests (a warm-up call, the median of 5),
                  the contract's 4096 requests once, 256 with the vocoder
                  once; requests/s, served and padded audio-s/s, peak
                  memory, the launches per call against the bucket plan,
                  the plan against the batches served; then fp32 on the
                  card against fp32 on the CPU at 8 requests;
 17. profile    — the same breakdown for one 256-request call;
     mesh       — data parallelism (``parallel/mesh.py``): at world size 1
                  over NCCL, ``Server(mesh=make_mesh())`` at level 5 (256
                  requests, bf16) per uid equal to the serve phase's
                  ``Server``, and the stage-1 step with ``mesh=`` at the
                  fp32 parity batch equal to the step without (then one
                  bf16 step at 16 x 1024 for its launches); then two ranks
                  of this script (``--rank-job mesh``) on the one card
                  over gloo: fp32 serving of 32 requests at batch 32 (16 a
                  rank) within 1e-4 of one process, the stage-1 step with
                  one utterance a rank against the one-process step; the
                  collectives' calls and ms per call;
     tensor     — tensor parallelism (the ``model`` axis): two ranks of this
                  script (``--rank-job tensor``) at (data 1, model 2) on
                  the one card over gloo, at full width: the stage-1 step's
                  fp32 losses and whole gradients at the parity batch
                  against one process, rank 1 bit-equal to rank 0, then
                  the bf16 step at 16 x 1024 (ms, launches per rank as the
                  one-process step's, the generator bytes a rank holds,
                  peak memory, the model axis's collectives' calls and ms);
                  ``dryrun_multichip(4)`` as four gloo ranks
                  (``--rank-job dryrun``); ``scaling_bench --mesh 1`` at
                  full width over NCCL at world size 1;
 18. verify     — the numerics gate, acceptance level 1
                  (``run_verification(max_frames=256, device="cuda")``);
 19. acceptance — acceptance level 2 at full size (batch 8 x 1024 frames,
                  1-step, mel only, bf16) through ``run_acceptance``: ms
                  per call, audio-s/s, peak memory and the launches per
                  call; then the port's commands in this process: ``accept
                  --level 0`` (levels 1-5, every report's keys, finite
                  numbers and gates), ``synth --ref`` a 1 s 16 kHz tone
                  with ``--wav-out`` (into ``chiprun_out/``) and ``bench``
                  (its one line).
Phase 3 also holds the training kernels (rows 3-5: the local-attention
forward with its log-sum-exp and the dq, dk/dv backward, with the
cotangent zeroed past the length as the decoder does and live there, and
the count of tile pairs each kind of the bf16 walk meets; row 7: the AdaIN
conv backward-data) against their plain versions at the train step's
shapes, rows 8 and 9 beside the card's launch floor (a one-block
elementwise op on 4 floats, timed the same way), and row 11, the
standalone iSTFT, at small shapes (every window and frame-count residue
its sm90 kernel handles, and the generic kernel's cases) and at the
vocoder head's two shapes; right after it, row 11's one entry point
(``dispatch.istft_head``, on no model path) runs with grad on.  After every path on the card no
plain version has seen a CUDA tensor.
Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; without a CUDA device it stops in
phase 1.  It imports nothing of JAX.

    python3 chip_smoke.py --against build/parent

runs phases 1 and 2 and then only times every row (1-7, 10 and 12 in
bf16; 2 also in fp32 at the denoiser's two shapes; 8, 9 and 11 in fp32),
at every shape the paths launch them, against the kernels of another
tree unpacked at that directory (``git archive <commit> | tar -x
-C build/parent``; its ``kernels/build.py`` builds them into its own
``build/``), each through its own tree's C entry point and held against
the plain version, in turns (parent, this, this, parent), after both
trees' registers, spills, shared memory and blocks per SM of those
kernels.

    python3 chip_smoke.py --paths-against build/parent

runs phases 1 and 2 and then the 1-step, multi-step, long-form and
serving phases (4, 5, 6 without its parity run, 7, 8, 9, 16 without its
4096-request, vocoder and parity runs, and 17) of that tree and of this
one in turns, each in its own process from its own root.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from styletts_zs_torch.config import (Config, ModelConfig,  # noqa: E402
                                      RuntimeConfig, ServeConfig,
                                      load_config)
from styletts_zs_torch import cli, graft_entry, scaling_bench  # noqa: E402
from styletts_zs_torch.bench import mel_mae  # noqa: E402
from styletts_zs_torch.kernels import adain_conv as ac_kernel  # noqa: E402
from styletts_zs_torch.kernels import build, dispatch, plain  # noqa: E402
from styletts_zs_torch.kernels import conv_transpose as ct_kernel  # noqa: E402
from styletts_zs_torch.kernels import full_attention as fa_kernel  # noqa: E402
from styletts_zs_torch.kernels import istft as istft_kernel  # noqa: E402
from styletts_zs_torch.kernels import local_attention as la_kernel  # noqa: E402
from styletts_zs_torch.kernels import sampler as sampler_kernel  # noqa: E402
from styletts_zs_torch.kernels import synthesis_head as head_kernel  # noqa: E402
from styletts_zs_torch.models.diffusion import karras_sigmas  # noqa: E402
from styletts_zs_torch.ops import align as align_ops  # noqa: E402
from styletts_zs_torch.ops import conv as conv_ops  # noqa: E402
from styletts_zs_torch.ops import stft as stft_ops  # noqa: E402
from styletts_zs_torch.ops.attention import length_mask  # noqa: E402
from styletts_zs_torch.parallel import bucketing  # noqa: E402
from styletts_zs_torch.parallel import collectives  # noqa: E402
from styletts_zs_torch.parallel import mesh as mesh_lib  # noqa: E402
from styletts_zs_torch.parallel import sharding as sharding_lib  # noqa: E402
from styletts_zs_torch.parallel import tensor as tensor_lib  # noqa: E402
from styletts_zs_torch.pipelines import acceptance  # noqa: E402
from styletts_zs_torch.pipelines.acceptance import (  # noqa: E402
    base_config, run_acceptance, synth_inputs)
from styletts_zs_torch.native import frontend as native_frontend  # noqa: E402
from styletts_zs_torch.pipelines import corpus as corpus_lib  # noqa: E402
from styletts_zs_torch.pipelines import eval as eval_lib  # noqa: E402
from styletts_zs_torch.pipelines import pipeline as pipeline_lib  # noqa: E402
from styletts_zs_torch.pipelines import train as train_lib  # noqa: E402
from styletts_zs_torch.pipelines.checkpoint import load_params  # noqa: E402
from styletts_zs_torch.pipelines.corpus import (  # noqa: E402
    read_wav, write_wav)
from styletts_zs_torch.pipelines.factory import (build_models,  # noqa: E402
                                                 init_params)
from styletts_zs_torch.pipelines.data import SyntheticDataset  # noqa: E402
from styletts_zs_torch.pipelines.infer import make_synthesis_fn  # noqa: E402
from styletts_zs_torch.pipelines.preprocess import (  # noqa: E402
    Utterance, collate, featurize)
from styletts_zs_torch.pipelines.serve import Request, Server  # noqa: E402
from styletts_zs_torch.pipelines.train import (G_PARTS,  # noqa: E402
                                               Stage1Trainer, Stage2Trainer,
                                               Stage3Trainer, batch_to_device)
from styletts_zs_torch.pipelines.verify import (  # noqa: E402
    _run as run_with_durations, run_verification)
from styletts_zs_torch.utils import audio as audio_utils  # noqa: E402
from styletts_zs_torch.utils import text as text_utils  # noqa: E402

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores
SM_CYCLES_PER_S = 1.98e9       # the SM's highest clock: a hold of n cycles
                               # lasts at least n / this seconds

# Tolerances of the kernel checks: |kernel - plain| <= atol + rtol * |plain|
# everywhere.  fp32: the two sum the same products in another order
# (~1e-6 relative).  bf16: the output is rounded to bf16 (2^-9 relative,
# one step is 0.016 at |x| in [2, 4)), and the plain version rounds the
# probabilities / sums the head conv in another order before rounding it
# to bf16, so a value can land one bf16 step apart before exp() and the
# overlap-add.
# The sampler kernels round every operation as the plain version does
# (1e-6 leaves room for a rare double rounding of its fp64 FMA).
# The two convs: fp32 sums 2 560 (AdaIN conv, K 5 x C 512) or 1 024
# (transposed conv, 2 taps x Cin 512) products in another order than cuBLAS
# in the plain version, with |y| up to ~5; bf16 rounds the output once, as
# the plain version does, so the two can land one bf16 step apart (the
# staged activations are rounded at the same place, so a flip there moves
# y by ~1e-4).
TOL = {
    "local_attention": {torch.float32: (1e-5, 1e-5),
                        torch.bfloat16: (1e-2, 1e-2)},
    "synthesis_head": {torch.float32: (1e-4, 1e-4),
                       torch.bfloat16: (2e-2, 2e-2)},
    "full_attention": {torch.float32: (1e-5, 1e-5),
                       torch.bfloat16: (1e-2, 1e-2)},
    "sampler_euler": {torch.float32: (1e-6, 1e-6)},
    "sampler_heun": {torch.float32: (1e-6, 1e-6)},
    "adain_conv": {torch.float32: (1e-4, 1e-4),
                   torch.bfloat16: (1e-2, 1e-2)},
    "conv_transpose": {torch.float32: (1e-4, 1e-4),
                       torch.bfloat16: (1e-2, 1e-2)},
    # rows 3-5: the forward and its lse as row 1; the backward sums up to
    # 768 products of p * (g v^T - delta) per output in another order (fp32
    # ~1e-7 relative); bf16 rounds p and dS before their products at the
    # same places as the plain version, so a value an ulp apart in fp32 can
    # round one bf16 step apart there (moving an output by ~1e-5), and the
    # output is rounded once: one bf16 step is under 1e-2 * |y|.
    "local_attention_fwd_lse": {torch.float32: (1e-5, 1e-5),
                                torch.bfloat16: (1e-2, 1e-2)},
    "local_attention_bwd_dq": {torch.float32: (1e-5, 1e-4),
                               torch.bfloat16: (1e-3, 1e-2)},
    "local_attention_bwd_dkv": {torch.float32: (1e-5, 1e-4),
                                torch.bfloat16: (1e-3, 1e-2)},
    # row 7: row 6's sums (2 560 products, |y| up to ~5) times silu'
    "adain_conv_bwd_data": {torch.float32: (1e-4, 1e-4),
                            torch.bfloat16: (1e-2, 1e-2)},
    # rows 1 and 2 (bf16) on a row with no valid key: every key at weight 1,
    # no scores, so the kernel's output is the fp32 mean of v rounded once to
    # bf16 (2^-8 relative); held against that mean, not the plain version,
    # which rounds the weights 1/W to bf16 first
    "attention_no_valid_key": {torch.bfloat16: (1e-5, 2 ** -8)},
    # row 11: each sample sums 4 frames x 50 basis products (|wav| < ~2)
    # in one fp32 accumulator, the plain version as a cuBLAS product and
    # then the overlap-add (~1e-7 relative apart); the gradient (its twin's,
    # on either device) sums the same products transposed
    "istft": {torch.float32: (1e-5, 1e-5)},
}
# Rows 4-5 in bf16 with the cotangent live past the length: there p can be
# 1 (a query chunk with no valid key, or a length of 1) while g is not 0, so
# dS = p (g v^T - delta) reaches |dS| ~ 8 on random data, where the
# decoder's case (g zeroed there) keeps |dS| << 1.  The kernel and the plain
# version each round dS (and, for dv, p) to bf16, from fp32 values that
# differ in the last bits (the products summed in another order, exp2 for
# exp), so a value within that difference of a bf16 rounding boundary can
# land one bf16 step (at most 2^-7 of it) apart and move an output by that
# step times |x| (x = k for dq, q for dk, g for dv; times D^-0.5 for dq and
# dk).  That case is held to TOL plus the sum of those moves over the
# values that can round apart: those within DP_ERR * (p sum_d |g v| +
# |dS| D^-0.5 sum_d |q k|) + 2^-19 |dS| of a boundary (dP and s summed in
# another order: the fp32 bound of a 64-term sum, 64 * 2^-24, four times
# over for the tensor cores' accumulation; exp2 against exp), from the
# plain version's own values.  The decoder's case is held to TOL alone.
BF16_STEP = 2.0 ** -7
DP_ERR = 2.0 ** -16
EXP_ERR = 2.0 ** -19
# The untrained duration head predicts log-durations near 0, which round to
# 0 frames: every utterance would be empty.  Its bias is set so that the
# 256 phonemes fill most of the 1024-frame bucket, as trained weights do.
DURATION_BIAS = float(np.log1p(3.5))
# fp32 on the card against fp32 on the CPU, through the whole path: the same
# arithmetic summed in another order through ~40 layers.
FP32_PATH_TOL = 1e-3
# The sampled style latent (|style| up to ~5.5) before the quantiser, which
# would absorb an error below a code step: 31 fp32 denoiser calls summed in
# another order (7.4e-6 measured on the card, batch 1).
STYLE_TOL = 1e-4
# The second text of the multi-step parity check, of max_text_len 256.
SHORT_TEXT = 200
# Long-form: 256 phonemes fill 4864 frames at ~19 frames each, so the
# duration head's bias is set for ~18 (the untrained head adds ~9 %).
LONGFORM_DURATION_BIAS = float(np.log1p(17.0))
# Stage-1 training: TrainConfig's batch of 16 clips of 1024 frames (12.8 s)
# and 256 phonemes, so the decoder's attention spans 4 chunks of 256 and
# runs the local-attention backward kernels.
TRAIN_FRAMES, TRAIN_TEXT = 1024, 256
# fp32 train step on the card against the CPU, at batch 2 (the seed gives
# two different frame lengths): each loss term within LOSS_RTOL relative
# (an fp32 forward through ~60 layers summed in another order; 1.5e-6
# measured); each gradient tensor within GRAD_RTOL of its own largest
# value, plus GRAD_FLOOR of the largest gradient of its model (a tensor
# whose gradient is zero by construction, such as the text-side alignment
# projection's bias under the softmax over text, holds only rounding).
# GRAD_RTOL is 1e-2, not 1e-3: the fp32 CPU reference run with 3 threads
# instead of 8 already differs from itself by 7.0e-3 of the largest value
# on the vocoder's stage-2 resblock biases (sums over 51 200 frames), and
# the card by 7.1e-3 (cuDNN's convs) or 7.0e-3 (PyTorch's own convs), so
# 1e-3 is below fp32's summation-order noise there; the script also prints
# how many tensors exceed 1e-3.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-2
GRAD_FLOOR = 1e-6
PARITY_SEED = 1
# Serving: with DURATION_BIAS the untrained duration head gives ~4.3 frames
# to each of level 5's random ARPAbet phonemes (3.9 gave 9 % more frames
# than the estimates on the card), so a request of e frames gets about
# e / 4.3 phonemes, BOS and EOS included.
SERVE_FRAMES_PER_PHONEME = 4.3
SOURCES = {
    "local_attention": ("styletts_zs_torch/csrc/local_attention.cu",
                        "styletts_zs_tpu/kernels/attention_kernel.py:35"),
    "synthesis_head": ("styletts_zs_torch/csrc/synthesis_head.cu",
                       "styletts_zs_tpu/kernels/vocoder_kernels.py:341"),
    "full_attention": ("styletts_zs_torch/csrc/full_attention.cu",
                       "styletts_zs_tpu/kernels/attention_kernel.py:123"),
    "sampler_euler": ("styletts_zs_torch/csrc/sampler.cu",
                      "styletts_zs_tpu/kernels/sampler_kernel.py:26"),
    "sampler_heun": ("styletts_zs_torch/csrc/sampler.cu",
                     "styletts_zs_tpu/kernels/sampler_kernel.py:41"),
    "adain_conv": ("styletts_zs_torch/csrc/adain_conv.cu",
                   "styletts_zs_tpu/kernels/decoder_kernels.py:43"),
    "conv_transpose": ("styletts_zs_torch/csrc/conv_transpose.cu",
                       "styletts_zs_tpu/kernels/vocoder_kernels.py:41"),
    "local_attention_fwd_lse": ("styletts_zs_torch/csrc/local_attention.cu",
                                "styletts_zs_tpu/kernels/attention_kernel.py:205"),
    "local_attention_bwd_dq": ("styletts_zs_torch/csrc/local_attention_bwd.cu",
                               "styletts_zs_tpu/kernels/attention_kernel.py:268"),
    "local_attention_bwd_dkv": ("styletts_zs_torch/csrc/local_attention_bwd.cu",
                                "styletts_zs_tpu/kernels/attention_kernel.py:301"),
    "adain_conv_bwd_data": ("styletts_zs_torch/csrc/adain_conv_bwd.cu",
                            "styletts_zs_tpu/kernels/decoder_kernels.py:203"),
    "istft": ("styletts_zs_torch/csrc/istft.cu",
              "styletts_zs_tpu/kernels/vocoder_kernels.py:271"),
}
MULTISTEP_CONFIG = REPO / "configs" / "multistep_b32.toml"
LONGFORM_CONFIG = REPO / "configs" / "longform_60s.toml"


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def timed(fn, iters: int = 10, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) per call after warm-up.  The device time is from
    CUDA events around ``iters`` calls that were enqueued while a sleep
    kernel held the stream, so it counts the calls back to back on the
    card and not the wrappers' host time, which a microsecond kernel would
    otherwise measure; the host time is that of the enqueue.  A function
    that waits for the card itself (the plain versions that copy a constant
    from host memory) outlasts the hold; it is timed again without it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = 2 * iters * (time.perf_counter() - t) + 1e-3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SM_CYCLES_PER_S))
    t0.record()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1.record()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    if host_s >= hold_s:
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_s * 1e3 / iters


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call (``timed``)."""
    return timed(fn, iters, warmup)[0]


def check_close(name: str, label: str, dtype, out, ref) -> float:
    """Hold ``out`` against ``ref`` with the stated tolerance; returns the
    max abs error."""
    atol, rtol = TOL[name][dtype]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - rtol * ref.float().abs()).max().item()
    print(f"  {name:15s} {str(dtype)[6:]:8s} {label:8s} max_abs_err "
          f"{err:.3e} (tol {atol:.0e} + {rtol:.0e}*|plain|, max |plain| "
          f"{ref.float().abs().max().item():.3f})")
    if not excess <= atol:
        raise AssertionError(f"{name} {dtype} {label}: max_abs_err {err}, "
                             f"exceeds atol {atol} + rtol {rtol}*|plain| "
                             f"by {excess - atol}")
    return err


def check_close_slack(name: str, label: str, dtype, out, ref,
                      slack) -> float:
    """``check_close`` with a per-element ``slack`` added to the bound;
    returns the max abs error."""
    atol, rtol = TOL[name][dtype]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - rtol * ref.float().abs() - slack).max().item()
    print(f"  {name:15s} {str(dtype)[6:]:8s} {label:8s} max_abs_err "
          f"{err:.3e} (tol {atol:.0e} + {rtol:.0e}*|plain| + slack, max "
          f"|plain| {ref.float().abs().max().item():.3f}, max slack "
          f"{slack.max().item():.3e}, excess over the TOL bound alone "
          f"{(diff - rtol * ref.float().abs()).max().item() - atol:.3e})")
    if not excess <= atol:
        raise AssertionError(f"{name} {dtype} {label}: max_abs_err {err}, "
                             f"exceeds atol {atol} + rtol {rtol}*|plain| + "
                             f"slack by {excess - atol}")
    return err


def bound_ms(n_bytes: float, flops: float, flop_rate: float):
    """Least time for the work: bytes over HBM rate vs operations over peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases 1 and 2: device and build
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device — this script runs "
                         "only on the card")
    smi = acceptance.device_label(torch.device("cuda", 0))
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> build.KernelLibrary:
    """Build the library and print each kernel's ``-Xptxas -v`` lines (entry,
    registers, spills); for the bf16 forwards of rows 1 and 2
    (``attention_fwd_sm90.cuh``) and row 2's fp32 kernel, the bf16 backward
    of rows 4 and 5, the bf16 kernels of rows 6, 7, 10 and 12 and row 11's
    sm90 kernel, their dynamic shared memory a block and blocks per SM from
    the occupancy API."""
    lib = build.library()
    print(f"built {lib.path.name} in {lib.build_seconds:.1f} s "
          f"({len(build.sources())} sources and {len(build.headers())} "
          f"header, one nvcc per source, in parallel)")
    for line in lib.log.splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)) \
                or "spill stores" in line or "Performance Loss" in line:
            print("  " + line.strip())
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    for label, fn, args in (
            ("attn_fwd_sm90_kernel row 1 bf16",
             lib.lib.local_attention_fwd_occupancy, ()),
            ("attn_fwd_sm90_kernel row 2 bf16 at Tk 256",
             lib.lib.full_attention_fwd_occupancy, (256,)),
            ("full_attn_f32_sm90_kernel row 2 fp32 at Tk 272",
             lib.lib.full_attention_f32_occupancy, (272,)),
            ("adain_conv_sm90_kernel row 6 bf16",
             lib.lib.adain_conv_fwd_occupancy, ()),
            ("adain_bwd_data_sm90_kernel row 7 bf16",
             lib.lib.adain_conv_bwd_data_occupancy, ()),
            ("conv_transpose_sm90_kernel row 10 bf16",
             lib.lib.conv_transpose_fwd_occupancy, ()),
            ("synth_head_sm90_kernel row 12 bf16",
             lib.lib.synthesis_head_fwd_occupancy, ()),
            ("dq_sm90_kernel row 4 bf16",
             lib.lib.local_attention_bwd_occupancy, (0,)),
            ("dkv_sm90_kernel row 5 bf16",
             lib.lib.local_attention_bwd_occupancy, (1,)),
            ("istft_sm90_kernel row 11 fp32 at n_fft 48",
             lib.lib.istft_sm90_occupancy, (48,))):
        build.check(fn(*args, ctypes.byref(blocks), ctypes.byref(smem)),
                    label)
        print(f"  {label}: {smem.value} bytes of dynamic shared memory a "
              f"block, {blocks.value} blocks per SM")
    return lib


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def _attention_inputs(dtype, masked: bool, g: torch.Generator,
                      T: int = 1024):
    """(B 32, T, H 8, D 64) q/k/v as strided views of one fused qkv
    projection, as the decoder hands them over."""
    B, H, D = 32, 8, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(dtype)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    if masked:
        lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
        lengths[:4] = torch.tensor([0, 1, min(T, 256), min(T, 700)],
                                   device="cuda")
    else:
        lengths = torch.full((B,), T, device="cuda")
    return q, k, v, lengths.to(torch.int32)


def _attention_work(lengths: torch.Tensor, T: int, H: int, D: int,
                    chunk: int, itemsize: int):
    """Bytes and matmul FLOPs the function needs.  Per batch row of length
    L: K for the keys below L; V for those and for the clipped window of
    each query chunk with no valid key, whose queries average it; Q for the
    queries of the chunks with a valid key; out written once; the lengths
    read.  QK^T and PV over the (query, key) pairs in band and length; a
    chunk with no valid key needs its window's mean alone, no product.  The
    bf16 kernel walks the key tiles ``la_kernel.valid_key_tiles`` names,
    which hold every one of these keys."""
    W = min(3 * chunk, T)
    c = min(chunk, T)                  # T <= c: one chunk of T queries
    ci = np.arange(T // c)
    lo = np.maximum((ci - 1) * chunk, 0)           # the band, clipped
    hi = np.minimum((ci + 2) * chunk, T)
    s0 = np.clip((ci - 1) * chunk, 0, T - W)       # the window
    rows = pairs = 0
    for L in lengths.tolist():
        L = min(L, T)
        has_key = np.minimum(hi, L) > lo
        v_keys = np.arange(T) < L
        for s in s0[~has_key]:
            v_keys[s:s + W] = True
        rows += c * int(has_key.sum()) + L + int(v_keys.sum()) + T
        pairs += c * int(np.clip(np.minimum(hi, L) - lo, 0, None).sum())
    n_bytes = rows * H * D * itemsize + 4 * lengths.numel()
    return n_bytes, pairs * H * 4 * D


def _attention_train_work(lengths: torch.Tensor, T: int, H: int, D: int,
                          chunk: int, itemsize: int) -> dict:
    """Bytes and matmul FLOPs that rows 3, 4 and 5 need, by kernel name.
    Per batch row of length L, query chunk i has a valid key when its band
    holds a key below L; a chunk without one averages its clipped window
    (p = 1 there, from lse = -1e30).

    Row 3: row 1's work (``_attention_work``) and the lse written.  Row 4
    (dq): Q of the chunks with a valid key; K and V below L and in the
    windows of the chunks without one; g, dq, lse and delta of every query;
    QK^T, g V^T and dS K over the valid pairs (6D each), g V^T and dS K over
    the windows of the chunks without one (4D).  Row 5 (dk, dv): key chunk
    j against query chunks j-1..j+1 (the band, masked by the length only):
    Q, g, lse and delta of every query, K below L, V below L and in the
    band of a query chunk without a valid key, dk and dv written; QK^T,
    g V^T, dS^T Q and P^T g over the valid pairs (8D), g V^T and dS^T Q
    over the band of a chunk without a valid key (4D; its P^T g is a sum).
    One int32 length a row read by each."""
    c, n, W = chunk, T // chunk, min(3 * chunk, T)
    ci = np.arange(n)
    lo = np.maximum((ci - 1) * c, 0)
    hi = np.minimum((ci + 2) * c, T)
    s0 = np.clip((ci - 1) * c, 0, T - W)
    rows_dq = rows_dkv = pairs_dq = pairs_dkv = 0
    for L in lengths.tolist():
        L = min(L, T)
        n_valid = np.clip(np.minimum(hi, L) - lo, 0, None)
        has = n_valid > 0
        kv_dq = np.arange(T) < L
        for s in s0[~has]:
            kv_dq[s:s + W] = True
        rows_dq += c * int(has.sum()) + 2 * int(kv_dq.sum()) + 2 * T
        pairs_dq += 6 * c * int(n_valid.sum()) + 4 * c * W * int((~has).sum())
        below = np.clip(L - ci * c, 0, c)           # keys of chunk j below L
        v_dkv = np.arange(T) < L
        for i in range(n):
            band = range(max(i - 1, 0), min(i + 2, n))
            if has[i]:
                pairs_dkv += 8 * c * int(sum(below[j] for j in band))
            else:
                v_dkv[band[0] * c:(band[-1] + 1) * c] = True
                pairs_dkv += 4 * c * c * len(band)
        rows_dkv += 2 * T + L + int(v_dkv.sum()) + 2 * T
    B = lengths.numel()
    stat, lens = B * H * T * 4, 4 * B
    fwd_bytes, fwd_flops = _attention_work(lengths, T, H, D, chunk, itemsize)
    return {"local_attention_fwd_lse": (fwd_bytes + stat, fwd_flops),
            "local_attention_bwd_dq": (rows_dq * H * D * itemsize + 2 * stat
                                       + lens, pairs_dq * H * D),
            "local_attention_bwd_dkv": (rows_dkv * H * D * itemsize
                                        + 2 * stat + lens,
                                        pairs_dkv * H * D)}


def _time_local_attention(fn, q, k, v, lengths, chunk: int,
                          label: str) -> dict:
    """Device times of ``fn`` (the kernel, as the path calls it), the plain
    version and SDPA on the same bf16 inputs, SDPA with the cheapest mask
    that computes the function: the dense band-and-length mask above two
    chunks; below, where the band holds every key, the (B, 1, 1, T) length
    mask, or none when every length is T.  Then the bound from the bytes
    and FLOPs the function needs."""
    B, T, H, D = q.shape
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(lambda: la_kernel.local_attention_plain(
        q, k, v, lengths, chunk=chunk), iters=3)
    mask = length_mask(lengths, T)[:, None, None, :]
    if T > 2 * chunk:
        t = torch.arange(T, device="cuda")
        band = ((t[:, None] // chunk) - (t[None, :] // chunk)).abs() <= 1
        mask = band[None, None] & mask
    elif bool((lengths == T).all()):
        mask = None
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), iters=5)
    n_bytes, flops = _attention_work(lengths.cpu(), T, H, D, chunk, 2)
    bms, by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    print(f"  local_attention bf16 B{B} T{T} H{H} D{D} c{chunk} {label}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def check_local_attention(chunk: int = 256) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    errs, inputs = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            q, k, v, lengths = inputs[masked] = _attention_inputs(dtype,
                                                                  masked, g)
            out = la_kernel.local_attention_cuda(q, k, v, lengths, chunk=chunk)
            ref = la_kernel.local_attention_plain(q, k, v, lengths, chunk=chunk)
            torch.cuda.synchronize()
            errs.append(check_close("local_attention",
                                    "masked" if masked else "full",
                                    dtype, out, ref))
    # batch row 0 has length 0: each query chunk averages its clipped window
    q, k, v, lengths = inputs[True]
    T = q.shape[1]
    out = la_kernel.local_attention_cuda(q, k, v, lengths, chunk=chunk)[0]
    W = min(3 * chunk, T)
    mean = torch.cat([v[0, s0:s0 + W].float().mean(0).expand(chunk, -1, -1)
                      for s0 in (max(0, min((ci - 1) * chunk, T - W))
                                 for ci in range(T // chunk))])
    check_close("attention_no_valid_key", "local", torch.bfloat16, out, mean)
    # times at the production dtype, masked (the row's numbers) and not
    res = {}
    for masked in (True, False):
        q, k, v, lengths = inputs[masked]
        res[masked] = _time_local_attention(
            lambda: la_kernel.local_attention_cuda(q, k, v, lengths,
                                                   chunk=chunk),
            q, k, v, lengths, chunk, "masked" if masked else "unmasked")
    res = {"max_abs_err": max(errs), **res[True], "unmasked": res[False]}
    short, err = _check_local_attention_short(chunk)
    res["max_abs_err"] = max(res["max_abs_err"], err)
    return {**res, **short}


def _check_local_attention_short(chunk: int) -> tuple[dict, float]:
    """Below three chunks, through ``dispatch.local_attention`` as the
    decoder calls it: at T 2c the local kernel takes the whole sequence as
    its window; at T c the call is one chunk and launches the full-attention
    kernel (row 2; the 256 bucket's decoder when serving).  Each against the
    local kernel's plain version, fp32 and bf16, masked and unmasked, batch
    32; times at bf16, masked and unmasked."""
    g = torch.Generator(device="cuda").manual_seed(6)
    res, errs = {}, []
    for T, kernel_name in ((2 * chunk, "local_attention"),
                           (chunk, "full_attention")):
        inputs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for masked in (False, True):
                q, k, v, lengths = inputs[masked] = _attention_inputs(
                    dtype, masked, g, T=T)
                mask = length_mask(lengths, T) if masked else None
                before = (la_kernel.launches, fa_kernel.launches)
                out = dispatch.local_attention(q, k, v, chunk=chunk,
                                               kv_mask=mask)
                launched = (la_kernel.launches - before[0],
                            fa_kernel.launches - before[1])
                want = (1, 0) if kernel_name == "local_attention" else (0, 1)
                if launched != want:
                    raise AssertionError(f"local attention at T {T}: "
                                         f"launched (local, full) {launched}, "
                                         f"expected {want}")
                ref = la_kernel.local_attention_plain(q, k, v, lengths,
                                                      chunk=chunk)
                torch.cuda.synchronize()
                errs.append(check_close(
                    "local_attention", f"T{T}{' masked' if masked else ''}",
                    dtype, out, ref))
        times = {}
        for masked in (True, False):
            q, k, v, lengths = inputs[masked]
            mask = length_mask(lengths, T) if masked else None
            times[masked] = _time_local_attention(
                lambda: dispatch.local_attention(q, k, v, chunk=chunk,
                                                 kv_mask=mask),
                q, k, v, lengths, chunk, f"through {kernel_name}"
                + (" masked" if masked else " unmasked"))
        res[f"T{T}"] = {"kernel": kernel_name, **times[True],
                        "unmasked": times[False]}
    return res, max(errs)


# Row 12's shapes on the paths: (B, T) of the vocoder head's input frames
# at the 1-step batch 32 (1024 mel frames x 25) and long-form (4 x 4864).
_HEAD_CASES = {"one_step_b32": (32, 25600), "long_form": (4, 121600)}


def _head_inputs(B: int, T: int, dtype, g, *, C: int = 128, K: int = 7,
                 n_fft: int = 48):
    """x (B, T, C) as a view of (B, C, T) memory, as the vocoder's last
    resblocks hand it over; a K-tap head conv (K, C, 3 n_freq) and bias."""
    n_freq = n_fft // 2 + 1
    x = (0.5 * torch.randn(B, C, T, generator=g, device="cuda")).to(dtype)
    w = torch.randn(K, C, 3 * n_freq, generator=g, device="cuda") \
        * (K * C) ** -0.5
    b = 0.1 * torch.randn(3 * n_freq, generator=g, device="cuda")
    return x.transpose(1, 2), w, b


def _synthesis_head_work(B: int, T: int, C: int, K: int, n_fft: int,
                         hop: int, itemsize: int) -> tuple[int, int]:
    """Bytes (x, the weight and bias in x's dtype, the fp32 synthesis basis
    and inverse envelope read once, the fp32 waveform written once) and
    the FLOPs the function needs: the head conv's products over the (frame,
    tap) pairs whose input row lies in [0, T) (the SAME padding's zeros
    need none), and the overlap-add's over the (frame, basis sample) pairs
    whose sample lands in the trimmed output."""
    n_freq = n_fft // 2 + 1
    out_len = (T - 1) * hop
    start = n_fft // 2
    halo = (K - 1) // 2
    conv_pairs = sum(max(0, T - abs(k - halo)) for k in range(K))
    s0 = np.arange(T, dtype=np.int64) * hop - start     # sample of n = 0
    ola_pairs = int(np.clip(np.minimum(n_fft, out_len - s0)
                            - np.maximum(0, -s0), 0, None).sum())
    n_bytes = ((B * T * C + K * C * 3 * n_freq + 3 * n_freq) * itemsize
               + (2 * n_freq * n_fft + out_len + n_fft) * 4
               + B * out_len * 4)
    flops = (2 * B * conv_pairs * C * 3 * n_freq
             + 2 * B * ola_pairs * 2 * n_freq)
    return n_bytes, flops


def check_synthesis_head(card: str, n_fft: int = 48, hop: int = 12,
                         K: int = 7) -> dict:
    """Row 12 at the vocoder heads of the 1-step batch 32 (32 x 25 600
    frames) and long-form (4 x 121 600), C 128, x the (B, C, T)-major view
    the vocoder hands over: fp32 and bf16 against the plain version (bf16
    also from a contiguous (B, T, C) x, which the wrapper copies into that
    layout); bf16 timed through ``dispatch.synthesis_head``, so a copy
    anywhere on the way would be counted, with the time such a copy takes
    beside it."""
    g = torch.Generator(device="cuda").manual_seed(2)
    C = 128
    res, errs = {}, []
    for label, (B, T) in _HEAD_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _head_inputs(B, T, dtype, g, C=C, K=K, n_fft=n_fft)
            out = head_kernel.synthesis_head_cuda(x, w, b, n_fft=n_fft,
                                                  hop=hop)
            ref = head_kernel.synthesis_head_plain(x, w, b, n_fft=n_fft,
                                                   hop=hop)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.shape != (B, (T - 1) * hop):
                raise AssertionError(f"head {label}: shape {out.shape} vs "
                                     f"{ref.shape}")
            errs.append(check_close("synthesis_head", label, dtype, out, ref))
            if label == "one_step_b32" and dtype == torch.bfloat16:
                out = head_kernel.synthesis_head_cuda(
                    x.contiguous(), w, b, n_fft=n_fft, hop=hop)
                torch.cuda.synchronize()
                errs.append(check_close("synthesis_head", "contiguous",
                                        dtype, out, ref))
            del out, ref
        ms = cuda_ms(lambda: dispatch.synthesis_head(x, w, b, n_fft=n_fft,
                                                     hop=hop))
        plain_ms = cuda_ms(lambda: head_kernel.synthesis_head_plain(
            x, w, b, n_fft=n_fft, hop=hop), iters=3)
        copy_ms = cuda_ms(lambda: x.contiguous())
        bms, by = bound_ms(*_synthesis_head_work(B, T, C, K, n_fft, hop, 2),
                           BF16_FLOP_PER_S)
        print(f"  synthesis_head bf16 {label} B{B} T{T} C{C} K{K} n_fft{n_fft} "
              f"hop{hop}, (B, C, T)-major x, through dispatch: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
              f"({by}); a contiguous copy of x would add {copy_ms:.4f} ms  "
              f"[{card}]")
        entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                 "bound_by": by, "library_ms": None, "copy_ms": copy_ms}
        if label == "one_step_b32":
            res.update(entry)
        else:
            res[label] = entry
        del x
    res["max_abs_err"] = max(errs)
    return res


def _full_attention_inputs(B, Tq, Tk, dtype, g, *, n_prompt=0,
                           self_attn=False):
    """q (B, Tq, 8, 64) from a q projection and k/v as views of one fused
    projection, as the model hands them over; with ``n_prompt`` the mask is
    the denoiser's [text | padding | prompt] (text lengths from 0 to the
    text), else a length mask (a length of 0 in row 0)."""
    H, D = 8, 64
    if self_attn:
        qkv = torch.randn(B, Tq, 3 * H * D, generator=g, device="cuda")
        q, k, v = (t.reshape(B, Tq, H, D) for t in
                   qkv.to(dtype).split(H * D, dim=-1))
    else:
        q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dtype)
        kv = torch.randn(B, Tk, 2 * H * D, generator=g, device="cuda")
        k, v = (t.reshape(B, Tk, H, D) for t in
                kv.to(dtype).split(H * D, dim=-1))
    Tt = Tk - n_prompt
    lengths = torch.randint(1, Tt + 1, (B,), generator=g, device="cuda")
    lengths[0] = 0
    mask = length_mask(lengths, Tt)
    if n_prompt:
        mask = torch.cat([mask, torch.ones(B, n_prompt, dtype=torch.bool,
                                           device="cuda")], dim=1)
        mask[1] = False                  # and a row with no valid key
    return q, k, v, mask


def _full_attention_work(q, k, mask):
    """Bytes and matmul FLOPs the function needs.  Per batch row: K and V
    for its valid keys and Q for its queries; a row with no valid key
    averages all Tk values, so it reads V alone and needs no product.  The
    mask (if any) read once, out written once; QK^T and PV over the (query,
    valid key) pairs.  The kernel walks the key tiles
    ``fa_kernel.valid_key_tiles`` names, which hold every one of these
    keys."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    n_valid = (torch.full((B,), Tk) if mask is None else mask.sum(-1).cpu())
    has_key = n_valid > 0
    rows = (Tq * int(has_key.sum()) + 2 * int(n_valid.sum())
            + Tk * int((~has_key).sum()) + B * Tq)
    n_bytes = (rows * H * D * q.element_size()
               + (0 if mask is None else mask.numel()))
    return n_bytes, 4 * H * D * Tq * int(n_valid.sum())


def _time_full_attention(q, k, v, mask, label: str, card: str) -> dict:
    ms, host_ms = timed(lambda: fa_kernel.full_attention_cuda(q, k, v, mask))
    plain_ms = cuda_ms(lambda: fa_kernel.full_attention_plain(q, k, v, mask),
                       iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask), iters=5)
    rate = FP32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    n_bytes, flops = _full_attention_work(q, k, mask)
    bms, by = bound_ms(n_bytes, flops, rate)
    B, Tq, H, D = q.shape
    print(f"  full_attention {label} B{B} Tq{Tq} Tk{k.shape[1]} H{H} D{D}: "
          f"kernel {ms:.4f} ms (host {host_ms:.4f} ms), plain {plain_ms:.4f} "
          f"ms, sdpa {library_ms:.4f} ms, bound {bms:.4f} ms ({by})"
          f"  [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def check_full_attention(card: str) -> dict:
    """The denoiser's self- and cross-attention (fp32, B 64 = the doubled
    batch 32, K 50 codes, 256 text + 16 prompt keys; masked with a text
    length of 0 and a row with no valid key, and the self-attention also
    unmasked) and the encoders' (bf16, batch 32: text 256, prompt 240 and
    its 16-query pooling); and in bf16 the ragged edges and the mask policy
    of the Hopper kernel: Tk 272 with the denoiser's [text | padding |
    prompt] mask, a text length of 0 and a row with no valid key, at Tq 50
    and 16.  The fp32 cross- and self-attention and the bf16 encoders'
    shapes are timed."""
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = {
        "den_cross": (64, 50, 272, torch.float32, dict(n_prompt=16)),
        "den_self": (64, 50, 50, torch.float32, dict(self_attn=True)),
        "text": (32, 256, 256, torch.bfloat16, dict(self_attn=True)),
        "prompt": (32, 240, 240, torch.bfloat16, dict(self_attn=True)),
        "pool": (32, 16, 240, torch.bfloat16, {}),
        "cross_bf16": (32, 50, 272, torch.bfloat16, dict(n_prompt=16)),
        "cross_bf16_q16": (32, 16, 272, torch.bfloat16, dict(n_prompt=16)),
    }
    errs, inputs = [], {}
    for label, (B, Tq, Tk, dtype, kw) in cases.items():
        q, k, v, mask = inputs[label] = _full_attention_inputs(
            B, Tq, Tk, dtype, g, **kw)
        masks = [mask, None] if label in ("den_self", "text") else [mask]
        for m in masks:
            out = fa_kernel.full_attention_cuda(q, k, v, m)
            ref = fa_kernel.full_attention_plain(q, k, v, m)
            torch.cuda.synchronize()
            errs.append(check_close("full_attention",
                                    label + ("" if m is not None else "-nm"),
                                    dtype, out, ref))
    # rows with no valid key (text: row 0, length 0; cross: row 1, no key
    # unmasked) average all Tk keys
    for label, row in (("text", 0), ("cross_bf16", 1)):
        q, k, v, mask = inputs[label]
        out = fa_kernel.full_attention_cuda(q, k, v, mask)[row]
        mean = v[row].float().mean(0).expand_as(out)
        check_close("attention_no_valid_key", label, torch.bfloat16, out,
                    mean)
    res = _time_full_attention(*inputs["den_cross"], "fp32 den_cross", card)
    # the denoiser's self-attention runs unmasked
    res["fp32_den_self"] = _time_full_attention(*inputs["den_self"][:3], None,
                                                "fp32 den_self", card)
    for label in ("text", "prompt", "pool"):
        res[f"bf16_{label}"] = _time_full_attention(*inputs[label],
                                                    f"bf16 {label}", card)
    res["max_abs_err"] = max(errs)
    return res


def check_sampler(card: str) -> dict:
    """Euler at step 0 and Heun at step 14 of the 16-step schedule, guidance
    3, on (32, 50, 128) fp32 latents; the denoiser halves as views."""
    sig = karras_sigmas(base_config(full=True).model.diffusion, 16)
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = (32, 50, 128)
    res = {}
    floor_ms = launch_floor(card)
    for name, i in (("sampler_euler", 0), ("sampler_heun", 14)):
        s_cur, s_next = sig[i], sig[i + 1]
        x = torch.randn(*shape, generator=g, device="cuda") * float(s_cur)
        den2 = torch.randn(2 * shape[0], *shape[1:], generator=g,
                           device="cuda")
        dc, du = den2[:shape[0]], den2[shape[0]:]
        if name == "sampler_euler":
            def kernel():
                return sampler_kernel.euler_step_cuda(x, dc, du, s_cur, s_next,
                                                      guidance=3.0)

            def plain():
                return sampler_kernel.euler_step_plain(x, dc, du, s_cur,
                                                       s_next, guidance=3.0)
            n_io, n_ops = 5, 7            # x, dc, du in; x', d out
        else:
            xe = x + torch.randn(*shape, generator=g, device="cuda")
            d1 = torch.randn(*shape, generator=g, device="cuda")

            def kernel():
                return sampler_kernel.heun_correction_cuda(
                    x, xe, dc, du, d1, s_cur, s_next, guidance=3.0)

            def plain():
                return sampler_kernel.heun_correction_plain(
                    x, xe, dc, du, d1, s_cur, s_next, guidance=3.0)
            n_io, n_ops = 6, 8            # x, xe, dc, du, d1 in; x' out
        outs, refs = kernel(), plain()
        torch.cuda.synchronize()
        if isinstance(outs, torch.Tensor):
            outs, refs = (outs,), (refs,)
        err = max(check_close(name, f"step{i} {lab}", torch.float32, o, r)
                  for o, r, lab in zip(outs, refs, ("x", "d")))
        err = max(err, _sampler_tail(name, s_cur, s_next, g))
        ms, host_ms = timed(kernel, iters=50)
        plain_ms = cuda_ms(plain, iters=50)
        bms, by = bound_ms(n_io * x.numel() * 4, n_ops * x.numel(),
                           FP32_FLOP_PER_S)
        print(f"  {name} {shape} fp32 sigma {s_cur:.4g} -> {s_next:.4g}: "
              f"kernel {ms:.4f} ms (its wrapper's host time {host_ms:.4f} "
              f"ms), plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by}), "
              f"the card's launch floor {floor_ms:.5f} ms; no single "
              f"library call  [{card}]")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "launch_floor_ms": floor_ms}
    return res


def launch_floor(card: str) -> float:
    """The card's launch floor: device ms of a one-block PyTorch elementwise
    op on 4 floats, timed as rows 8-9 are (``timed``, 50 launches back to
    back behind a held stream): what any launch takes, whatever its work."""
    x = torch.randn(4, device="cuda")
    y = torch.empty_like(x)
    ms, host_ms = timed(lambda: torch.mul(x, 2.0, out=y), iters=50)
    print(f"  launch floor: torch.mul on 4 fp32 values (one block) {ms:.5f} "
          f"ms (host {host_ms:.4f} ms a launch)  [{card}]")
    return ms


def _sampler_tail(name: str, s_cur, s_next, g) -> float:
    """The kernel at 3*5*7 values (26 float4s and a tail of 1) against its
    plain version; returns the max abs error."""
    x, dc, du, xe, d1 = (torch.randn(3, 5, 7, generator=g, device="cuda")
                         for _ in range(5))
    if name == "sampler_euler":
        outs = sampler_kernel.euler_step_cuda(x, dc, du, s_cur, s_next,
                                              guidance=3.0)
        refs = sampler_kernel.euler_step_plain(x, dc, du, s_cur, s_next,
                                               guidance=3.0)
    else:
        outs = (sampler_kernel.heun_correction_cuda(
            x, xe, dc, du, d1, s_cur, s_next, guidance=3.0),)
        refs = (sampler_kernel.heun_correction_plain(
            x, xe, dc, du, d1, s_cur, s_next, guidance=3.0),)
    torch.cuda.synchronize()
    return max(check_close(name, "tail", torch.float32, o, r)
               for o, r in zip(outs, refs))


def device_kernels(fn) -> str:
    """The device kernels one call of ``fn`` launches, with their times
    (``torch.profiler``), as one line."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return "; ".join(f"{e.key[:70]} x{e.count} "
                     f"{e.self_device_time_total / 1e3:.3f} ms"
                     for e in sorted(evs, key=lambda e: -e.self_device_time_total))


def _conv_time_label(ms, plain_ms, library_ms, bms, by, card) -> str:
    return (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})  [{card}]")


def _adain_inputs(B: int, T: int, dtype, g, *, time_varying: bool,
                  c_out: int = 512):
    """x (B, T, 512) and pass 1's scale/shift as the decoder hands them over:
    strided views at channel offsets 0 and 2C of the style projection's
    (B, T, 4C) output (or of a (B, 4C) global one); the statistics of x; a
    K 5 weight (K, C, c_out): c_out below C is a tensor-parallel chunk."""
    C, K = 512, 5
    x = torch.randn(B, T, C, generator=g, device="cuda").to(dtype)
    mod_shape = (B, T, 4 * C) if time_varying else (B, 4 * C)
    mod = (0.3 * torch.randn(*mod_shape, generator=g, device="cuda")).to(dtype)
    scale, shift = mod.split(2 * C, dim=-1)
    w = (torch.randn(K, C, c_out, generator=g, device="cuda")
         * (K * C) ** -0.5).to(dtype)
    return (x, scale[..., :C], shift[..., :C], *ac_kernel.instance_stats(x),
            w)


def _adain_library(x, sc, sh, mean, rstd, w, dilation):
    """The same function as PyTorch ops and one cuDNN convolution: what the
    port ran before the kernel."""
    if sc.ndim == 2:
        sc, sh = sc[:, None], sh[:, None]
    h = torch.nn.functional.silu(
        (x.float() - mean[:, None]) * rstd[:, None] * (1.0 + sc.float())
        + sh.float()).to(x.dtype)
    return conv_ops.conv1d(h, w, dilation=dilation)


def _adain_work(x, sc, sh, w, dilation: int):
    """Bytes (x, scale, shift, the statistics and w read once, y written
    once; a global scale or shift is one (C) row a batch row) and the
    products' FLOPs of one pass: the (frame, tap) pairs whose input row
    lies in [0, T) (the SAME padding's zero rows need no products)."""
    B, T, C = x.shape
    K, _, C_out = w.shape
    it = x.element_size()
    halo = (K - 1) * dilation // 2
    pairs = sum(max(0, T - abs(k * dilation - halo)) for k in range(K))
    n_bytes = ((x.numel() + sc[..., 0].numel() * C + sh[..., 0].numel() * C
                + w.numel() + B * T * C_out) * it + 2 * B * C * 4)
    return n_bytes, 2 * B * pairs * C * C_out


# Row 6's shapes on the paths, (B, T): long-form, the 1-step batch 32 (and
# serving's 1024 bucket), serving's 512 and 256 buckets, the train step's
# forward.  The fp32 variant is checked at the first two.
_ADAIN_CASES = {"long_form": (4, 4864), "one_step_b32": (32, 1024),
                "serve_512": (32, 512), "serve_256": (32, 256),
                "train_b16": (16, 1024)}


def check_adain_conv(card: str) -> dict:
    """The fused AdaIN conv pass (row 6) at every shape the paths launch
    (``_ADAIN_CASES``), C 512 -> 512, K 5: bf16 (and fp32 at the long-form
    and 1-step batch-32 shapes), dilations 1, 3 and 9, time-varying and
    global style.  Times at bf16 with time-varying style, per dilation
    (global style at d 1 too); the library time is the PyTorch modulation
    plus cuDNN's dilated conv."""
    g = torch.Generator(device="cuda").manual_seed(7)
    res, errs = {}, []
    for label, (B, T) in _ADAIN_CASES.items():
        dtypes = ((torch.float32, torch.bfloat16)
                  if label in ("long_form", "one_step_b32")
                  else (torch.bfloat16,))
        for dtype in dtypes:
            for tv in (True, False):
                args = _adain_inputs(B, T, dtype, g, time_varying=tv)
                for d in (1, 3, 9):
                    out = ac_kernel.adain_conv_pass_cuda(*args, dilation=d)
                    ref = ac_kernel.adain_conv_pass_plain(*args, dilation=d)
                    torch.cuda.synchronize()
                    errs.append(check_close(
                        "adain_conv", f"{label} d{d}{'' if tv else ' global'}",
                        dtype, out, ref))
        glob = _adain_inputs(B, T, torch.bfloat16, g, time_varying=False)
        global_ms = cuda_ms(lambda: ac_kernel.adain_conv_pass_cuda(
            *glob, dilation=1))
        args = _adain_inputs(B, T, torch.bfloat16, g, time_varying=True)
        h = _adain_library(*args, 1)
        for d in (1, 3, 9):
            bms, by = bound_ms(*_adain_work(*args[:3], args[5], d),
                               BF16_FLOP_PER_S)
            ms = cuda_ms(lambda: ac_kernel.adain_conv_pass_cuda(*args,
                                                                dilation=d))
            plain_ms = cuda_ms(lambda: ac_kernel.adain_conv_pass_plain(
                *args, dilation=d), iters=3)
            library_ms = cuda_ms(lambda: _adain_library(*args, d), iters=5)
            conv_ms = cuda_ms(lambda: conv_ops.conv1d(h, args[5], dilation=d),
                              iters=5)
            print(f"  adain_conv bf16 {label} B{B} T{T} 512->512 K5 d{d}: "
                  + _conv_time_label(ms, plain_ms, library_ms, bms, by, card)
                  + f"; cuDNN conv alone {conv_ms:.4f} ms"
                  + (f"; global style {global_ms:.4f} ms" if d == 1 else ""))
            if label == "one_step_b32":
                print(f"    cuDNN kernels of the library call: "
                      f"{device_kernels(lambda: _adain_library(*args, d))}")
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": library_ms}
            if d == 1:
                entry["global_ms"] = global_ms
            if label == "long_form" and d == 1:
                res.update(entry)
            else:
                res[f"{label}_d{d}"] = entry
        del args, glob, h
    res.update(_check_adain_conv_chunks(card, g, errs))
    res["max_abs_err"] = max(errs)
    return res


# The tensor-parallel stage-1 step's chunks of the decoder's 512 output
# channels at the train step's shape: model 2 (the 256-channel block) and
# model 4 (the 128-channel block, m64n128k16).
TP_CHUNKS = (256, 128)
TP_SHAPE = (16, 1024)


def _check_adain_conv_chunks(card: str, g, errs: list) -> dict:
    """Row 6 on the weight chunks ``TP_CHUNKS`` at ``TP_SHAPE``: bf16 at
    dilations 1, 3 and 9 with time-varying and global style, fp32 at d 1;
    times at bf16, and the two blocks set side by side on the same work
    (one 512 -> 256 launch against two 512 -> 128 launches)."""
    B, T = TP_SHAPE
    res, d1 = {}, {}
    for c_out in TP_CHUNKS:
        for dtype in (torch.float32, torch.bfloat16):
            for tv in (True, False):
                args = _adain_inputs(B, T, dtype, g, time_varying=tv,
                                     c_out=c_out)
                for d in ((1, 3, 9) if dtype == torch.bfloat16 else (1,)):
                    out = ac_kernel.adain_conv_pass_cuda(*args, dilation=d)
                    ref = ac_kernel.adain_conv_pass_plain(*args, dilation=d)
                    torch.cuda.synchronize()
                    errs.append(check_close(
                        "adain_conv", f"chunk 512->{c_out} d{d}"
                        f"{'' if tv else ' global'}", dtype, out, ref))
        args = _adain_inputs(B, T, torch.bfloat16, g, time_varying=True,
                             c_out=c_out)
        for d in (1, 3, 9):
            bms, by = bound_ms(*_adain_work(*args[:3], args[5], d),
                               BF16_FLOP_PER_S)
            ms = cuda_ms(lambda: ac_kernel.adain_conv_pass_cuda(
                *args, dilation=d))
            plain_ms = cuda_ms(lambda: ac_kernel.adain_conv_pass_plain(
                *args, dilation=d), iters=3)
            library_ms = cuda_ms(lambda: _adain_library(*args, d), iters=5)
            print(f"  adain_conv bf16 tensor-parallel chunk B{B} T{T} "
                  f"512->{c_out} K5 d{d} ({ac_kernel.sm90_tile(c_out)}-"
                  f"channel block): "
                  + _conv_time_label(ms, plain_ms, library_ms, bms, by, card))
            res[f"chunk_{c_out}_d{d}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "library_ms": library_ms}
            if d == 1:
                d1[c_out] = ms
        del args
    print(f"  adain_conv the same work, 512->256 at B{B} T{T} d1: one launch "
          f"on the 256-channel block {d1[256]:.4f} ms, two on the 128-channel "
          f"block {2 * d1[128]:.4f} ms  [{card}]")
    return res


# Row 10's shapes on the paths: (B, T, Cin, Cout) of the vocoder's two
# stages for long-form (B 4, 4864 frames) and the 1-step batch 32.
_CONVT_CASES = {"long_form_stage1": (4, 4864, 512, 256),
                "long_form_stage2": (4, 24320, 256, 128),
                "one_step_b32_stage1": (32, 1024, 512, 256),
                "one_step_b32_stage2": (32, 5120, 256, 128),
                # the tensor-parallel step's up0 chunk at model 2
                "chunk_train_stage1": (16, 1024, 512, 128)}


def _convt_inputs(B, T, C_in, C_out, dtype, g):
    """x (B, T, Cin) as a view of (B, Cin, T) memory, as the vocoder's
    resblocks hand it over, and a K 10 weight (K, Cin, Cout)."""
    x = torch.randn(B, C_in, T, generator=g, device="cuda").to(dtype)
    w = (torch.randn(10, C_in, C_out, generator=g, device="cuda")
         * (2 * C_in) ** -0.5).to(dtype)
    return x.transpose(1, 2), w


def _convt_library(x, w, stride):
    """The same function as one leaky ReLU and cuDNN's transposed conv."""
    return conv_ops.conv_transpose1d(torch.nn.functional.leaky_relu(x, 0.1),
                                     w, stride=stride)


def check_conv_transpose(card: str) -> dict:
    """The transposed conv (row 10), K 10, stride 5, leaky ReLU fused, at
    the vocoder's two stages for long-form (B 4: 4864 -> 24 320 frames,
    512 -> 256 channels; 24 320 -> 121 600, 256 -> 128) and for the 1-step
    batch 32 (1024 and 5120 frames), fp32 and bf16, x read in its (B, C,
    T)-major layout; one bf16 case also from a contiguous (B, T, C) x
    without the activation.  Times at bf16, with the cost of the copy that
    reading the layout in place saves."""
    g = torch.Generator(device="cuda").manual_seed(8)
    r = 5
    res, errs = {}, []
    for label, (B, T, C_in, C_out) in _CONVT_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, w = _convt_inputs(B, T, C_in, C_out, dtype, g)
            out = ct_kernel.conv_transpose1d_cuda(x, w, stride=r,
                                                  negative_slope=0.1)
            ref = ct_kernel.conv_transpose1d_plain(x, w, stride=r,
                                                   negative_slope=0.1)
            torch.cuda.synchronize()
            if out.shape != (B, T * r, C_out):
                raise AssertionError(f"conv_transpose {label}: shape "
                                     f"{tuple(out.shape)}")
            errs.append(check_close("conv_transpose", label, dtype, out, ref))
            del out, ref
        if label == "long_form_stage1":
            xc = x.contiguous()
            out = ct_kernel.conv_transpose1d_cuda(xc, w, stride=r)
            ref = ct_kernel.conv_transpose1d_plain(xc, w, stride=r)
            torch.cuda.synchronize()
            errs.append(check_close("conv_transpose", "contiguous",
                                    torch.bfloat16, out, ref))
            del xc, out, ref
        ms = cuda_ms(lambda: ct_kernel.conv_transpose1d_cuda(
            x, w, stride=r, negative_slope=0.1))
        plain_ms = cuda_ms(lambda: ct_kernel.conv_transpose1d_plain(
            x, w, stride=r, negative_slope=0.1), iters=3)
        library_ms = cuda_ms(lambda: _convt_library(x, w, r), iters=5)
        copy_ms = cuda_ms(lambda: x.contiguous())
        it = x.element_size()
        n_bytes = (x.numel() + w.numel() + B * T * r * C_out) * it
        bms, by = bound_ms(n_bytes, 2 * B * T * 10 * C_in * C_out,
                           BF16_FLOP_PER_S)
        print(f"  conv_transpose bf16 {label} ({B}, {T}, {C_in}) -> ({B}, "
              f"{T * r}, {C_out}): "
              + _conv_time_label(ms, plain_ms, library_ms, bms, by, card)
              + f"; a contiguous copy of x would add {copy_ms:.4f} ms")
        if label.startswith("one_step_b32"):
            print(f"    cuDNN kernels of the library call: "
                  f"{device_kernels(lambda: _convt_library(x, w, r))}")
        entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                 "bound_by": by, "library_ms": library_ms,
                 "copy_ms": copy_ms}
        if label == "long_form_stage1":
            res.update(entry)
        else:
            res[label] = entry
    res["max_abs_err"] = max(errs)
    return res


# ---------------------------------------------------------------------------
# phase 3, training kernels: rows 3-5 and 7
# ---------------------------------------------------------------------------

def _attention_train_inputs(B, T, dtype, g, chunk, *,
                           zero_masked_rows: bool = True):
    """q/k/v as views of one fused projection; key lengths that mask part
    of the last chunks: length T - 2c leaves the last chunk's queries with
    no valid key (all of them at T 2c) and length 0 every chunk's; the
    output's cotangent, zeroed on the query rows past the length as the
    decoder's mask zeroes it (or not: the rows-4/5 paths of the chunks with
    no valid key, p = 1, then see nonzero data)."""
    H, D = 8, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(dtype)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    lengths = torch.randint(T - 2 * chunk + 1, T + 1, (B,), generator=g,
                            device="cuda")
    lengths[:4] = torch.tensor([T, T - 1, T - 2 * chunk, 0], device="cuda")
    lengths = lengths.to(torch.int32)
    gout = torch.randn(B, T, H, D, generator=g, device="cuda")
    if zero_masked_rows:
        gout = gout * length_mask(lengths, T)[..., None, None]
    return q, k, v, gout.to(dtype), lengths


def _bwd_walk_pairs(lengths, T: int, chunk: int) -> dict:
    """How many (64-row tile, 64-row tile) pairs of each kind the bf16
    kernels of rows 4 and 5 meet on these lengths, per head: row 4's
    (query tile, key tile of its window) walked "full" (a chunk with a
    valid key), "ones" (one without) or skipped; row 5's (key tile, query
    tile of chunks j-1..j+1) walked "full", "ones" or skipped
    (``la_kernel.valid_key_tiles``, ``la_kernel.bwd_dkv_query_tiles``)."""
    W, per_chunk = min(3 * chunk, T), chunk // 64
    dq = {"full": 0, "ones": 0, "skipped": 0}
    dkv = dict(dq)
    for L in lengths:
        for ci in range(T // chunk):
            _, n_tiles, has_key = la_kernel.valid_key_tiles(ci, T, chunk, L)
            dq["full" if has_key else "ones"] += per_chunk * n_tiles
            dq["skipped"] += per_chunk * (W // 64 - n_tiles)
        for k0 in range(0, T, 64):
            j = k0 // chunk
            band = per_chunk * (min(j + 2, T // chunk) - max(j - 1, 0))
            walk = la_kernel.bwd_dkv_query_tiles(k0, T, chunk, L)
            for _, mode in walk:
                dkv[mode] += 1
            dkv["skipped"] += band - len(walk)
    return {"local_attention_bwd_dq": dq, "local_attention_bwd_dkv": dkv}


def _no_valid_key_chunks(lengths, T: int, chunk: int):
    """(batch row, query chunk, window start) of each query chunk whose band
    holds no key below the length."""
    W = min(3 * chunk, T)
    for b, L in enumerate(lengths):
        for ci in range(T // chunk):
            if min((ci + 2) * chunk, T, L) <= max((ci - 1) * chunk, 0):
                yield b, ci, max(0, min((ci - 1) * chunk, T - W))


def _check_no_valid_key(out, lse, v, lengths, chunk: int, label: str):
    """Row 3 on the query chunks with no valid key: lse exactly -1e30, and
    (bf16) the output the fp32 mean of v over the clipped window."""
    T = v.shape[1]
    W = min(3 * chunk, T)
    chunks = list(_no_valid_key_chunks(lengths.tolist(), T, chunk))
    if not chunks:
        raise AssertionError(f"{label}: the inputs hold no chunk without a "
                             f"valid key")
    rows = [slice(ci * chunk, (ci + 1) * chunk) for _, ci, _ in chunks]
    got_lse = torch.cat([lse[b, :, r] for (b, _, _), r in zip(chunks, rows)])
    if not bool((got_lse == -1e30).all()):
        raise AssertionError(f"{label}: lse of a chunk with no valid key is "
                             f"not -1e30 (max {got_lse.max().item()})")
    if out.dtype == torch.bfloat16:
        got = torch.cat([out[b, r] for (b, _, _), r in zip(chunks, rows)])
        mean = torch.cat([v[b, s0:s0 + W].float().mean(0).expand(chunk, -1, -1)
                          for b, _, s0 in chunks])
        check_close("attention_no_valid_key", label, torch.bfloat16, got, mean)
    print(f"  local_attention_fwd_lse {label}: {len(chunks)} query chunks "
          f"with no valid key, lse -1e30")


def _sdpa_mask(lengths, T, chunk):
    t = torch.arange(T, device="cuda")
    band = ((t[:, None] // chunk) - (t[None, :] // chunk)).abs() <= 1
    return band[None, None] & length_mask(lengths, T)[:, None, None, :]


def _flip_slack(x, err, y_abs, scale: float, eq: str):
    """``scale`` * the sum over the entries of ``x`` (fp32 values rounded to
    bf16 before a product) that lie within ``err`` of a bf16 rounding
    boundary, of one bf16 step of them times ``y_abs`` (the note at
    ``BF16_STEP``)."""
    r = x.bfloat16().float()
    _, e = torch.frexp(r)
    half_step = torch.ldexp(torch.ones_like(r), e - 9)   # |r| = m 2^e
    near = half_step - (x - r).abs() <= err
    return scale * torch.einsum(eq, torch.where(near, BF16_STEP * x.abs(),
                                                0.0), y_abs)


def _bf16_rounding_slack(args, chunk: int) -> dict:
    """Per output element of dq, dk and dv, what rounding dS and p to bf16
    can move it by between the kernel and the plain version (the note at
    ``BF16_STEP``), from the plain versions' p and dS."""
    q, k, v, g = args[:4]
    B, T, H, D = q.shape
    n, scale = T // chunk, D ** -0.5
    qc, gc, kc, vc = (x.reshape(B, n, chunk, H, D).float().abs()
                      for x in (q, g, k, v))
    p, ds, key = la_kernel._bwd_dq_terms(*args, chunk)
    kw = k[:, key].float().abs()
    s_abs = scale * torch.einsum("bnqhd,bnkhd->bnhqk", qc, kw)
    err = DP_ERR * (p * torch.einsum("bnqhd,bnkhd->bnhqk", gc,
                                     v[:, key].float().abs())
                    + ds.abs() * s_abs) + EXP_ERR * ds.abs()
    dq = _flip_slack(ds, err, kw, scale, "bnhqk,bnkhd->bnqhd")
    del p, ds, kw, s_abs, err
    p, ds, qidx = la_kernel._bwd_dkv_terms(*args, chunk)
    qw, gw = q[:, qidx].float().abs(), g[:, qidx].float().abs()
    s_abs = scale * torch.einsum("bnqhd,bnkhd->bnhqk", qw, kc)
    err = DP_ERR * (p * torch.einsum("bnqhd,bnkhd->bnhqk", gw, vc)
                    + ds.abs() * s_abs) + EXP_ERR * ds.abs()
    dk = _flip_slack(ds, err, qw, scale, "bnhqk,bnqhd->bnkhd")
    dv = _flip_slack(p, p * (DP_ERR * s_abs + EXP_ERR), gw, 1.0,
                     "bnhqk,bnqhd->bnkhd")
    return {"dq": dq.reshape(q.shape), "dk": dk.reshape(q.shape),
            "dv": dv.reshape(q.shape)}


def _check_attention_train_case(B, T, chunk, g, label) -> tuple[dict, dict]:
    """Rows 3, 4 and 5 against their plain versions, fp32 and bf16; times
    at bf16.  Returns (max abs errors, times) by kernel."""
    errs = {"local_attention_fwd_lse": 0.0, "local_attention_bwd_dq": 0.0,
            "local_attention_bwd_dkv": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g_live, lengths = _attention_train_inputs(
            B, T, dtype, g, chunk, zero_masked_rows=False)
        out, lse = la_kernel.local_attention_fwd_lse_cuda(q, k, v, lengths,
                                                          chunk=chunk)
        ref_out, ref_lse = la_kernel.local_attention_fwd_lse_plain(
            q, k, v, lengths, chunk=chunk)
        _check_no_valid_key(out, lse, v, lengths.cpu(), chunk,
                            f"{label} {str(dtype)[6:]}")
        for what, o, r in (("out", out, ref_out), ("lse", lse, ref_lse)):
            errs["local_attention_fwd_lse"] = max(
                errs["local_attention_fwd_lse"], check_close(
                    "local_attention_fwd_lse", f"{label} {what}", dtype, o, r))
        # the cotangent live past the length, then zeroed there (the
        # decoder's; the timed inputs)
        for g_label, gout in (
                ("g live", g_live),
                ("g zeroed",
                 g_live * length_mask(lengths, T)[..., None, None])):
            delta = (gout.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            args = (q, k, v, gout, lse, delta, lengths)
            dq = la_kernel.local_attention_bwd_dq_cuda(*args, chunk=chunk)
            dk, dv = la_kernel.local_attention_bwd_dkv_cuda(*args,
                                                            chunk=chunk)
            ref_dq = la_kernel.local_attention_bwd_dq_plain(*args,
                                                            chunk=chunk)
            ref_dk, ref_dv = la_kernel.local_attention_bwd_dkv_plain(
                *args, chunk=chunk)
            torch.cuda.synchronize()
            slack = (_bf16_rounding_slack(args, chunk)
                     if dtype == torch.bfloat16 and g_label == "g live"
                     else None)
            for name, pairs in (
                    ("local_attention_bwd_dq", (("dq", dq, ref_dq),)),
                    ("local_attention_bwd_dkv", (("dk", dk, ref_dk),
                                                 ("dv", dv, ref_dv)))):
                for what, o, r in pairs:
                    tag = f"{label} {g_label} {what}"
                    errs[name] = max(errs[name], check_close(
                        name, tag, dtype, o, r) if slack is None else
                        check_close_slack(name, tag, dtype, o, r,
                                          slack[what]))
            del slack, ref_dq, ref_dk, ref_dv
        del ref_out, ref_lse
    pairs = _bwd_walk_pairs(lengths.tolist(), T, chunk)
    for name, kinds in pairs.items():
        print(f"  {name} {label}: (tile, tile) pairs a head of the bf16 "
              f"walk: {kinds}")
        if not all(kinds.values()):
            raise AssertionError(f"{name} {label}: the inputs leave a kind "
                                 f"of pair unexercised: {kinds}")
    fwd = lambda: la_kernel.local_attention_fwd_lse_cuda(  # noqa: E731
        q, k, v, lengths, chunk=chunk)
    dq_fn = lambda: la_kernel.local_attention_bwd_dq_cuda(  # noqa: E731
        *args, chunk=chunk)
    dkv_fn = lambda: la_kernel.local_attention_bwd_dkv_cuda(  # noqa: E731
        *args, chunk=chunk)
    plain_fns = {
        "local_attention_fwd_lse": lambda: la_kernel.local_attention_fwd_lse_plain(
            q, k, v, lengths, chunk=chunk),
        "local_attention_bwd_dq": lambda: la_kernel.local_attention_bwd_dq_plain(
            *args, chunk=chunk),
        "local_attention_bwd_dkv": lambda: la_kernel.local_attention_bwd_dkv_plain(
            *args, chunk=chunk)}
    # the library: SDPA with the band and length mask, forward, then its
    # backward alone (dq, dk and dv in one call)
    mask = _sdpa_mask(lengths, T, chunk)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_ms(lambda: sdpa(qt.detach(), kt.detach(), vt.detach(),
                                   attn_mask=mask), iters=5)
    lib_out = sdpa(qt, kt, vt, attn_mask=mask)
    gt = gout.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), gt, retain_graph=True), iters=5)
    work = _attention_train_work(lengths.cpu(), T, 8, 64, chunk, 2)
    times = {}
    for name, fn in (("local_attention_fwd_lse", fwd),
                     ("local_attention_bwd_dq", dq_fn),
                     ("local_attention_bwd_dkv", dkv_fn)):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain_fns[name], iters=2)
        lib = lib_fwd if name.endswith("lse") else lib_bwd
        bms, by = bound_ms(*work[name], BF16_FLOP_PER_S)
        print(f"  {name} bf16 {label} B{B} T{T} H8 D64 c{chunk}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{'forward' if name.endswith('lse') else 'backward (dq, dk, dv)'}"
              f" {lib:.4f} ms, bound {bms:.4f} ms ({by})")
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lib}
    # delta, the PyTorch reduction that LocalAttention.backward runs before
    # rows 4 and 5 (not a kernel of the port): its device time beside theirs
    delta_ms = cuda_ms(lambda: (gout.float() * out.float()).sum(-1)
                       .transpose(1, 2).contiguous())
    delta_bound, _ = bound_ms(2 * 2 * gout.numel() + 4 * B * 8 * T, 0, 1)
    print(f"  delta = sum_d g * out (PyTorch) bf16 {label} B{B} T{T} H8 D64: "
          f"{delta_ms:.4f} ms, bound {delta_bound:.4f} ms (bytes: g and out "
          f"read, delta written)")
    return errs, times


def check_local_attention_train(card: str, chunk: int = 256) -> dict:
    """Rows 3, 4 and 5 at the train step's shape (B 16, T 1024, H 8, D 64,
    c 256) and at T 512 = 2c, masked, fp32 and bf16."""
    g = torch.Generator(device="cuda").manual_seed(9)
    res = {}
    errs, times = _check_attention_train_case(16, 1024, chunk, g, "T1024")
    errs2, times2 = _check_attention_train_case(16, 2 * chunk, chunk, g,
                                                f"T{2 * chunk}")
    for name in errs:
        res[name] = {"max_abs_err": max(errs[name], errs2[name]),
                     **times[name], f"T{2 * chunk}": times2[name]}
    print(f"  (rows 3-5 timed on [{card}])")
    return res


def _adain_bwd_library(dc, x, sc, sh, mean, rstd, w, dilation):
    """The same function from PyTorch: cuDNN's conv backward-data
    (``torch.nn.grad.conv1d_input``) and the silu' multiply."""
    B, T, C = x.shape
    K = w.shape[0]
    da = torch.nn.grad.conv1d_input(
        (B, C, T), w.permute(2, 1, 0), dc.transpose(1, 2),
        padding=(K - 1) * dilation // 2, dilation=dilation)
    return (da.transpose(1, 2).float()
            * ac_kernel._dsilu(x, sc, sh, mean, rstd)).to(dc.dtype)


def check_adain_conv_bwd(card: str) -> dict:
    """Row 7 at the train step's shape (B 16, T 1024, C 512 -> 512, K 5):
    fp32 and bf16, dilations 1, 3 and 9, time-varying and global style;
    times at bf16 with time-varying style."""
    g = torch.Generator(device="cuda").manual_seed(10)
    B, T = 16, 1024
    res, errs = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for tv in (True, False):
            args = _adain_inputs(B, T, dtype, g, time_varying=tv)
            dc = torch.randn(B, T, 512, generator=g, device="cuda").to(dtype)
            for d in (1, 3, 9):
                out = ac_kernel.adain_conv_bwd_data_cuda(dc, *args,
                                                         dilation=d)
                ref = ac_kernel.adain_conv_bwd_data_plain(dc, *args,
                                                          dilation=d)
                torch.cuda.synchronize()
                errs.append(check_close(
                    "adain_conv_bwd_data", f"d{d}{'' if tv else ' global'}",
                    dtype, out, ref))
    args = _adain_inputs(B, T, torch.bfloat16, g, time_varying=True)
    dc = torch.randn(B, T, 512, generator=g, device="cuda").to(torch.bfloat16)
    for d in (1, 3, 9):
        n_bytes, flops = _adain_work(*args[:3], args[5], d)
        bms, by = bound_ms(n_bytes + dc.numel() * 2, flops, BF16_FLOP_PER_S)
        ms = cuda_ms(lambda: ac_kernel.adain_conv_bwd_data_cuda(
            dc, *args, dilation=d))
        plain_ms = cuda_ms(lambda: ac_kernel.adain_conv_bwd_data_plain(
            dc, *args, dilation=d), iters=3)
        library_ms = cuda_ms(lambda: _adain_bwd_library(dc, *args, d),
                             iters=5)
        print(f"  adain_conv_bwd_data bf16 B{B} T{T} 512->512 K5 d{d}: "
              + _conv_time_label(ms, plain_ms, library_ms, bms, by, card))
        entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                 "bound_by": by, "library_ms": library_ms}
        if d == 1:
            res.update(entry)
        else:
            res[f"d{d}"] = entry
    # the tensor-parallel step's chunks: dc of 256 (model 2) and 128
    # (model 4) output channels, a partial dh over all 512 input channels
    for c_out in TP_CHUNKS:
        for dtype in (torch.float32, torch.bfloat16):
            for tv in (True, False):
                args = _adain_inputs(B, T, dtype, g, time_varying=tv,
                                     c_out=c_out)
                dc = torch.randn(B, T, c_out, generator=g,
                                 device="cuda").to(dtype)
                for d in ((1, 3, 9) if dtype == torch.bfloat16 else (1,)):
                    out = ac_kernel.adain_conv_bwd_data_cuda(dc, *args,
                                                             dilation=d)
                    ref = ac_kernel.adain_conv_bwd_data_plain(dc, *args,
                                                              dilation=d)
                    torch.cuda.synchronize()
                    errs.append(check_close(
                        "adain_conv_bwd_data", f"chunk dc {c_out} d{d}"
                        f"{'' if tv else ' global'}", dtype, out, ref))
        args = _adain_inputs(B, T, torch.bfloat16, g, time_varying=True,
                             c_out=c_out)
        dc = torch.randn(B, T, c_out, generator=g, device="cuda").to(
            torch.bfloat16)
        n_bytes, flops = _adain_work(*args[:3], args[5], 1)
        bms, by = bound_ms(n_bytes + dc.numel() * 2, flops, BF16_FLOP_PER_S)
        ms = cuda_ms(lambda: ac_kernel.adain_conv_bwd_data_cuda(
            dc, *args, dilation=1))
        plain_ms = cuda_ms(lambda: ac_kernel.adain_conv_bwd_data_plain(
            dc, *args, dilation=1), iters=3)
        library_ms = cuda_ms(lambda: _adain_bwd_library(dc, *args, 1),
                             iters=5)
        print(f"  adain_conv_bwd_data bf16 tensor-parallel chunk B{B} T{T} "
              f"dc {c_out} -> partial dh 512, K5 d1: "
              + _conv_time_label(ms, plain_ms, library_ms, bms, by, card))
        res[f"chunk_{c_out}"] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bms, "bound_by": by,
                                 "library_ms": library_ms}
    res["max_abs_err"] = max(errs)
    return res


def _istft_library(real, imag, n_fft: int, hop: int):
    """``torch.istft`` of the same spectrum: the complex (B, n_freq, F)
    tensor built outside the timed call, a periodic Hann window of n_fft
    (as ``ops/stft.py``'s), centred, (F-1)*hop samples."""
    spec = torch.complex(real, imag).transpose(1, 2)
    window = torch.hann_window(n_fft, device=real.device)
    length = (real.shape[1] - 1) * hop
    return lambda: torch.istft(spec, n_fft, hop_length=hop, win_length=n_fft,
                               window=window, center=True, length=length)


# Row 11 at small shapes: every window the sm90 kernel is built for, frame
# counts of every residue mod 4 and batches whose spectra end on no 16 bytes
# (the threads load the last floats), slots fewer than the grid (one slot a
# block: every run starts a row's walk) and more; hop 5 (no divisor of 48:
# the overlap-add sample by sample), M = 32 (the ring carries 31 frames,
# all it can), hop 20 > n_fft; then the generic kernel: a window the sm90
# kernel does not take, M = 48, and spectra that start 4 bytes off 16.
# (n_fft, hop, B, F, offset in floats)
_ISTFT_SMALL = (
    *[(48, 12, B, F, 0) for B in (1, 3)
      for F in (2, 3, 5, 10, 63, 64, 65, 100, 101, 130, 1027)],
    *[(16, 4, 3, F, 0) for F in (2, 10, 101, 130, 2051)],
    *[(n, n // 4, 3, F, 0) for n in (32, 64) for F in (10, 103, 1025)],
    (48, 5, 3, 101, 0), (32, 1, 2, 300, 0), (64, 2, 2, 300, 0),
    (16, 20, 3, 50, 0), (20, 5, 3, 101, 0), (48, 1, 2, 300, 0),
    (48, 12, 3, 101, 1))


def _check_istft_small(g) -> float:
    """Row 11 against its plain version at ``_ISTFT_SMALL``; returns the
    max abs error."""
    errs = []
    for n_fft, hop, B, F, off in _ISTFT_SMALL:
        n_freq = n_fft // 2 + 1
        real, imag = (torch.randn(B * F * n_freq + off, generator=g,
                                  device="cuda")[off:].view(B, F, n_freq)
                      for _ in range(2))
        sm90 = (istft_kernel.takes_sm90(n_fft, hop) and
                real.data_ptr() % 16 == 0 and imag.data_ptr() % 16 == 0)
        out = istft_kernel.istft_cuda(real, imag, n_fft=n_fft, hop=hop)
        ref = istft_kernel.istft_plain(real, imag, n_fft=n_fft, hop=hop)
        torch.cuda.synchronize()
        errs.append(check_close(
            "istft", f"n{n_fft}h{hop}B{B}F{F}{'' if sm90 else ' generic'}",
            torch.float32, out, ref))
    return max(errs)


def check_istft(card: str, n_fft: int = 48, hop: int = 12) -> dict:
    """Row 11 in fp32 at ``_ISTFT_SMALL``, then at the vocoder head's
    geometry and its two shapes, where the sm90 kernel runs: the 1-step
    head (32 x 25 600 frames: 1024 mel frames x 25) and the long-form head
    (4 x 121 600); kernel, plain, ``torch.istft`` (when it agrees with the
    plain version within the tolerance) and the bound."""
    g = torch.Generator(device="cuda").manual_seed(9)
    n_freq = n_fft // 2 + 1
    res, errs = {}, [_check_istft_small(g)]
    for B, F in ((32, 25600), (4, 121600)):
        real, imag = (torch.randn(B, F, n_freq, generator=g, device="cuda")
                      for _ in range(2))

        def kernel():
            return istft_kernel.istft_cuda(real, imag, n_fft=n_fft, hop=hop)

        def plain_fn():
            return istft_kernel.istft_plain(real, imag, n_fft=n_fft, hop=hop)
        out, ref = kernel(), plain_fn()
        torch.cuda.synchronize()
        if out.shape != ref.shape:
            raise AssertionError(f"istft shape {out.shape} vs {ref.shape}")
        errs.append(check_close("istft", f"B{B}F{F}", torch.float32, out,
                                ref))
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain_fn, iters=3)
        library = _istft_library(real, imag, n_fft, hop)
        atol, rtol = TOL["istft"][torch.float32]
        lib_diff = (library() - ref).abs()
        lib_err = lib_diff.max().item()
        library_ms = (cuda_ms(library, iters=5) if
                      (lib_diff - rtol * ref.abs()).max().item() <= atol
                      else None)
        n_bytes = (real.numel() + imag.numel() + out.numel()) * 4
        flops = 2 * B * F * 2 * n_freq * n_fft
        bms, by = bound_ms(n_bytes, flops, FP32_FLOP_PER_S)
        lib_txt = (f"{library_ms:.4f} ms" if library_ms is not None else
                   f"none (max_abs_err {lib_err:.2e} against the plain "
                   f"version)")
        print(f"  istft fp32 B{B} F{F} n_fft{n_fft} hop{hop}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.istft {lib_txt}, "
              f"bound {bms:.4f} ms ({by}; {n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)  [{card}]")
        res[f"B{B}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": library_ms,
                        "library_max_abs_err": lib_err}
    return {"max_abs_err": max(errs), **res["B32"], "long_form": res["B4"]}


def phase_kernel_checks(card: str) -> dict:
    return {"local_attention": check_local_attention(),
            "synthesis_head": check_synthesis_head(card),
            "full_attention": check_full_attention(card),
            **check_sampler(card),
            "adain_conv": check_adain_conv(card),
            "conv_transpose": check_conv_transpose(card),
            **check_local_attention_train(card),
            "adain_conv_bwd_data": check_adain_conv_bwd(card),
            "istft": check_istft(card)}


def phase_istft_head(card: str, n_fft: int = 48, hop: int = 12) -> dict:
    """Row 11's one entry point, ``dispatch.istft_head``, on CUDA tensors
    with grad on, as JAX's ``istft_head(use_pallas=True)``: one kernel
    launch forward, one twin backward and no plain version on the card;
    the output and the gradient against the same call on the CPU (the plain
    version and the twin's gradient there).  The model paths never call it
    (the synthesis head's twin takes ``ops.stft.istft``, as JAX's does)."""
    g = torch.Generator().manual_seed(10)
    B, F = 4, 2048
    n_freq = n_fft // 2 + 1
    real, imag = (torch.randn(B, F, n_freq, generator=g) for _ in range(2))
    cot = torch.randn(B, (F - 1) * hop, generator=g)

    def run(device):
        xs = [x.to(device).requires_grad_() for x in (real, imag)]
        out = dispatch.istft_head(*xs, n_fft=n_fft, hop=hop)
        return (out, *torch.autograd.grad(out, xs, cot.to(device)))
    reset_counts()
    got = run("cuda")
    torch.cuda.synchronize()
    counts = kernel_counts(torch.device("cuda"))
    twins = dict(plain.twin_vjp_calls)
    check_no_plain_on_card("istft_head")
    check_counts("istft_head", counts, {"istft": 1}, 1)
    if twins != {"istft": 1}:
        raise AssertionError(f"istft_head backward: twin backwards {twins}, "
                             f"expected one of istft")
    ref = run("cpu")
    for name, a, b in zip(("wav", "d_real", "d_imag"), got, ref):
        check_close("istft", name, torch.float32, a.cpu(), b)
    print(f"  dispatch.istft_head B{B} F{F} with grad on: kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }, twin backwards "
          f"{twins}, no plain version on the card  [{card}]")
    return {"counts": counts, "n_calls": 1}


# ---------------------------------------------------------------------------
# phase 4: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

def reset_counts() -> None:
    la_kernel.launches = 0
    la_kernel.fwd_lse_launches = 0
    la_kernel.bwd_dq_launches = 0
    la_kernel.bwd_dkv_launches = 0
    head_kernel.launches = 0
    fa_kernel.launches = 0
    ac_kernel.launches = 0
    ac_kernel.bwd_data_launches = 0
    ct_kernel.launches = 0
    istft_kernel.launches = 0
    for counts in (sampler_kernel.launches, dispatch.plain_calls):
        for name in counts:
            counts[name] = 0
    plain.cuda_calls.clear()
    plain.twin_vjp_calls.clear()


def kernel_counts(device: torch.device) -> dict:
    """CUDA launches on the card; plain-version calls on the CPU."""
    if device.type == "cuda":
        return {"local_attention": la_kernel.launches,
                "synthesis_head": head_kernel.launches,
                "full_attention": fa_kernel.launches,
                **sampler_kernel.launches,
                "adain_conv": ac_kernel.launches,
                "conv_transpose": ct_kernel.launches,
                "local_attention_fwd_lse": la_kernel.fwd_lse_launches,
                "local_attention_bwd_dq": la_kernel.bwd_dq_launches,
                "local_attention_bwd_dkv": la_kernel.bwd_dkv_launches,
                "adain_conv_bwd_data": ac_kernel.bwd_data_launches,
                "istft": istft_kernel.launches}
    return dict(dispatch.plain_calls)


def check_no_plain_on_card(label: str) -> None:
    """Fail if a plain version saw a CUDA tensor since the counts were set
    to 0: every op on the card must have launched its kernel."""
    if plain.cuda_calls:
        raise AssertionError(f"{label}: plain versions ran on the card "
                             f"{plain.cuda_calls}")


def check_counts(label: str, counts: dict, expect: dict, n_calls: int) -> None:
    """Fail unless every kernel launched ``expect[name]`` times a call over
    ``n_calls`` calls, and a kernel absent from ``expect`` never (a kernel
    that ``expect`` lists at 0 is a fault of the expectation)."""
    wrong = [f"{name}: {n} calls in {n_calls} {label} calls, expected "
             f"{expect.get(name, 0)} each" for name, n in counts.items()
             if (name in expect and expect[name] == 0)
             or n != expect.get(name, 0) * n_calls]
    if wrong:
        raise AssertionError("; ".join(wrong))


def sampler_calls(cfg: Config, one_step: bool, n_steps=None) -> tuple:
    """(denoiser calls, Euler steps, Heun corrections) of one sampler run:
    a correction wherever the next sigma of the schedule is above 0."""
    if one_step:
        return 1, 0, 0
    sig = karras_sigmas(cfg.model.diffusion,
                        n_steps or cfg.model.diffusion.n_steps)
    n_heun = int((sig[1:] > 0).sum())
    return len(sig) - 1 + n_heun, len(sig) - 1, n_heun


def expected_counts(cfg: Config, n_frames: int, *, one_step: bool = True,
                    n_steps=None, with_vocoder: bool = True) -> dict:
    """Kernel calls one synthesis call makes: one local attention per
    decoder attention block, or a full attention where the frames fit in
    one chunk; a full attention per text, prosody and prompt encoder block,
    the prompt pooling and, per denoiser call, each block's self- and
    cross-attention; two AdaIN conv passes per decoder block; the sampler's
    Euler steps and Heun corrections; with the vocoder, a transposed conv
    per upsampling stage and one head.  No kernel has a shape gate."""
    m = cfg.model
    d, v = m.decoder, m.vocoder
    n_attn = sum(1 for i in range(d.n_blocks) if (i + 1) % d.attn_every == 0)
    n_den, n_euler, n_heun = sampler_calls(cfg, one_step, n_steps)
    expect = {"full_attention": (m.text_encoder.n_attn_layers
                                 + m.prosody_encoder.n_layers
                                 + m.prompt_encoder.n_layers + 1
                                 + 2 * n_den * m.diffusion.n_layers),
              "adain_conv": 2 * d.n_blocks}
    if n_frames > d.attn_window:
        expect["local_attention"] = n_attn
    else:
        expect["full_attention"] += n_attn
    if not one_step:
        expect.update(sampler_euler=n_euler, sampler_heun=n_heun)
    if with_vocoder:
        expect.update(synthesis_head=1, conv_transpose=len(v.upsample_rates))
    return expect


def drive_main_path(cfg: Config, fn, inputs, *, device, n_calls: int,
                    one_step: bool = True, n_steps=None,
                    with_vocoder: bool = True, n_frames=None) -> dict:
    """Run ``fn`` (made for ``n_frames``, by default the config's
    ``max_frames``) ``n_calls`` times, each timed to its end, with the
    kernel counts set to 0 just before and read just after; check the
    counts (every kernel of the path launched as often as expected, no
    other, and on the card no plain version), shapes and finiteness."""
    device = torch.device(device)
    n_frames = n_frames or cfg.model.max_frames
    expect = expected_counts(cfg, n_frames, one_step=one_step,
                             n_steps=n_steps, with_vocoder=with_vocoder)
    if device.type == "cuda":
        torch.cuda.synchronize()
    times = []
    reset_counts()
    for _ in range(n_calls):
        t0 = time.perf_counter()
        out, wav = fn(*inputs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kernel_counts(device)
    if device.type == "cuda":
        check_no_plain_on_card(f"{n_frames}-frame path")
    check_counts("synthesis", counts, expect, n_calls)
    B = inputs[0].shape[0]
    if with_vocoder:
        n_up = int(np.prod(cfg.model.vocoder.upsample_rates))
        n_samples = (n_frames * n_up - 1) * cfg.model.vocoder.istft_hop
        if wav.shape != (B, n_samples) or not torch.isfinite(wav).all():
            raise AssertionError(f"waveform {tuple(wav.shape)} (expected "
                                 f"{(B, n_samples)}) finite="
                                 f"{bool(torch.isfinite(wav).all())}")
    elif wav is not None:
        raise AssertionError("a waveform from a path without the vocoder")
    if out.mel.shape != (B, n_frames, cfg.model.audio.n_mels) or \
            not torch.isfinite(out.mel.float()).all():
        raise AssertionError(f"mel {tuple(out.mel.shape)} not finite or not "
                             f"(B, frames, n_mels)")
    return {"seconds": float(np.median(times)), "times": times,
            "counts": counts, "per_call": expect, "out": out, "wav": wav}


def phase_main_path(card: str) -> dict:
    cfg = base_config(full=True)
    m = cfg.model
    params = init_params(cfg, seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    fn = make_synthesis_fn(cfg, params, device="cuda")
    audio_s = ((m.max_frames * int(np.prod(m.vocoder.upsample_rates)) - 1)
               * m.vocoder.istft_hop / m.audio.sample_rate)
    res = {}
    for batch, n_calls in ((1, 10), (32, 5)):
        inputs = synth_inputs(cfg, batch, "cuda")
        fn(*inputs)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = drive_main_path(cfg, fn, inputs, device="cuda", n_calls=n_calls)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res[batch] = r
        lens = r["out"].frame_lengths
        ms = [t * 1e3 for t in r["times"]]
        print(f"  batch {batch}: {r['seconds'] * 1e3:.1f} ms/call (median of "
              f"{n_calls}, min {min(ms):.1f}, max {max(ms):.1f}), frames "
              f"{int(lens.min())}..{int(lens.max())} of {m.max_frames}, waveform "
              f"{tuple(r['wav'].shape)} finite, kernel launches {r['counts']} "
              f"in {n_calls} calls ({r['per_call']} expected per call), "
              f"peak memory "
              f"{peak_gb:.2f} GB  [{card}]")
        res[f"peak_gb_{batch}"] = peak_gb
    rtf1 = audio_s / res[1]["seconds"]
    tput = 32 * audio_s / res[32]["seconds"]
    print(f"  audio-s/s at batch 32: {tput:.1f}  [{card}]")
    print(f"  RTF at batch 1 (audio-s per wall-s, bench.py's definition): "
          f"{rtf1:.1f}  [{card}]")
    print(f"  peak memory: batch 1 {res['peak_gb_1']:.2f} GB, batch 32 "
          f"{res['peak_gb_32']:.2f} GB  [{card}]")
    # the same weights and inputs in fp32: on the card (the kernels) and on
    # the CPU (the plain versions); then the bf16 card path against the CPU
    cfg32 = Config(model=m, runtime=RuntimeConfig(compute_dtype="float32"))
    inputs1 = synth_inputs(cfg, 1, "cpu")
    t0 = time.perf_counter()
    ref_out, ref_wav = make_synthesis_fn(cfg32, params, device="cpu")(*inputs1)
    t_cpu = time.perf_counter() - t0
    out32, wav32 = make_synthesis_fn(cfg32, params, device="cuda")(
        *(x.cuda() for x in inputs1))
    check_no_plain_on_card("1-step fp32 card path")
    if not torch.equal(out32.durations.cpu(), ref_out.durations):
        raise AssertionError("fp32 card durations differ from the CPU's")
    mel_err = (out32.mel.cpu() - ref_out.mel).abs().max().item()
    wav_err = (wav32.cpu() - ref_wav).abs().max().item()
    print(f"  fp32 card vs fp32 CPU plain path, batch 1: durations equal, "
          f"mel max_abs_err {mel_err:.2e}, waveform max_abs_err "
          f"{wav_err:.2e} (tol {FP32_PATH_TOL:.0e}; CPU run {t_cpu:.1f} s)")
    if not max(mel_err, wav_err) <= FP32_PATH_TOL:
        raise AssertionError(f"fp32 card path vs CPU: {mel_err}, {wav_err}")
    mae = mel_mae(res[1]["out"], ref_out)
    same_dur = bool(torch.equal(res[1]["out"].durations.cpu(),
                                ref_out.durations))
    print(f"  mel MAE bf16 card vs fp32 CPU plain path, batch 1: {mae:.5f} "
          f"(durations equal: {same_dur})")
    # What moves that MAE, duration flips or the kernels' bf16 drift: the
    # bf16 card program again with the fp32 CPU durations fed in, first
    # with its own sampled style, then with the fp32 CPU style too.
    # Reported, not gated.
    same = {"card bf16 style": style_latent(
        cfg, params, tuple(x.cuda() for x in inputs1), device="cuda",
        one_step=True, quantized=True)}
    same["CPU fp32 style"] = style_latent(cfg32, params, inputs1,
                                          device="cpu", one_step=True,
                                          quantized=True)
    style_diff = (same["card bf16 style"].float().cpu()
                  - same["CPU fp32 style"]).abs().max().item()
    for label, style in same.items():
        out_d, _ = run_with_durations(
            cfg, params, inputs1[0], inputs1[1], style, ref_out.durations,
            m.max_frames, device="cuda")
        print(f"  mel MAE bf16 card vs fp32 CPU plain path, batch 1, the "
              f"CPU durations fed in, {label}: {mel_mae(out_d, ref_out):.5f} "
              f"(quantised styles differ by {style_diff:.3e} at most)")
    check_no_plain_on_card("1-step bf16 card path with fed durations")
    return {"counts": {k: res[1]["counts"][k] + res[32]["counts"][k]
                       for k in res[1]["counts"]},
            "n_calls": len(res[1]["times"]) + len(res[32]["times"]), "fn": fn,
            "inputs32": synth_inputs(cfg, 32, "cuda")}


def with_denoiser_gates(params, seed: int = 0):
    """The denoiser's AdaLN modulation drawn like its other Dense layers
    (LeCun normal, from ``seed``) instead of DiT's zero init, under which
    every block is the identity and its attention never reaches the
    sampled style.  A copy; the other weights are shared."""
    g = torch.Generator().manual_seed(seed)
    diff = dict(params["diffusion"])
    for name, w in diff.items():
        if ".adaln_mod.weight" in name:
            diff[name] = torch.randn(w.shape, generator=g) * w.shape[1] ** -0.5
    return {**params, "diffusion": diff}


def style_latent(cfg: Config, params, inputs, *, device, n_steps=None,
                 guidance=None, one_step: bool = False,
                 quantized: bool = False):
    """The sampler's (B, K, d_style) style, before quantisation (or after,
    as the synthesis path hands it on), on the same path as
    ``make_synthesis_fn(one_step=...)``."""
    mods = build_models(cfg, params, device=device)
    phonemes, text_lengths, ref_mel, ref_lengths, noise = inputs
    with torch.inference_mode():
        text_mask = length_mask(text_lengths, phonemes.shape[1])
        tokens, summary = mods.acoustic.encode_prompt(
            ref_mel, length_mask(ref_lengths, ref_mel.shape[1]))
        text_enc, _ = mods.acoustic.encode_text(phonemes, text_mask)
        if one_step:
            style = mods.diffusion.sample_onestep(
                noise, text_enc, tokens, summary, text_mask=text_mask,
                guidance=guidance)
        else:
            style = mods.diffusion.sample(noise, text_enc, tokens, summary,
                                          text_mask=text_mask,
                                          n_steps=n_steps, guidance=guidance)
        return mods.acoustic.quantize_style(style) if quantized else style


def multistep_config() -> Config:
    """The full-width model with the serve settings of acceptance
    config 3, read by the port's own ``load_config``."""
    serve = load_config(str(MULTISTEP_CONFIG)).serve
    if serve.one_step or serve.with_vocoder:
        raise AssertionError(f"{MULTISTEP_CONFIG.name}: expected the "
                             f"multi-step mel path, got {serve}")
    return dataclasses.replace(base_config(full=True), serve=serve)


def phase_multistep(card: str, light: bool = False) -> dict:
    """Acceptance config 3 on the card; unless ``light``, then fp32 on the
    card against fp32 on the CPU at batch 2."""
    cfg = multistep_config()
    m, sv = cfg.model, cfg.serve
    params = init_params(cfg, seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    params = with_denoiser_gates(params)
    kw = dict(one_step=False, n_steps=sv.n_steps, guidance=sv.guidance,
              with_vocoder=sv.with_vocoder)
    fn = make_synthesis_fn(cfg, params, device="cuda", **kw)
    inputs = synth_inputs(cfg, sv.batch_size, "cuda")
    fn(*inputs)                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_calls = 5
    r = drive_main_path(cfg, fn, inputs, device="cuda", n_calls=n_calls,
                        one_step=False, n_steps=sv.n_steps,
                        with_vocoder=sv.with_vocoder)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    audio_s = sv.batch_size * m.max_frames * m.audio.hop_length \
        / m.audio.sample_rate
    ms = [t * 1e3 for t in r["times"]]
    lens = r["out"].frame_lengths
    print(f"  batch {sv.batch_size}, {sv.n_steps} steps, guidance "
          f"{sv.guidance}, mel only: {r['seconds'] * 1e3:.1f} ms/call "
          f"(median of {n_calls}, min {min(ms):.1f}, max {max(ms):.1f}), "
          f"frames {int(lens.min())}..{int(lens.max())} of {m.max_frames}, "
          f"mel {tuple(r['out'].mel.shape)} finite  [{card}]")
    print(f"  audio-s/s: {audio_s / r['seconds']:.1f} ({audio_s:.1f} audio-s "
          f"of mel per call); peak memory {peak_gb:.2f} GB  [{card}]")
    print(f"  kernel launches per call: "
          f"{ {k: n / n_calls for k, n in r['counts'].items()} } (counted "
          f"{r['counts']} in {n_calls} calls; expected {r['per_call']})")
    res = {"counts": r["counts"], "n_calls": n_calls, "fn": fn,
           "inputs": inputs}
    if light:
        return res
    # fp32 on the card (the kernels) against fp32 on the CPU (the plain
    # versions), the same weights and inputs, batch 2 with the second text
    # shorter than the text, so the denoiser's cross-attention mask is
    # [text | padding | prompt]
    cfg32 = dataclasses.replace(cfg, runtime=RuntimeConfig(
        compute_dtype="float32"))
    inputs1 = synth_inputs(cfg, 2, "cpu")
    inputs1[1][1] = SHORT_TEXT
    t0 = time.perf_counter()
    ref_out, _ = make_synthesis_fn(cfg32, params, device="cpu", **kw)(*inputs1)
    ref_style = style_latent(cfg32, params, inputs1, device="cpu",
                             n_steps=sv.n_steps, guidance=sv.guidance)
    t_cpu = time.perf_counter() - t0
    inputs1c = tuple(x.cuda() for x in inputs1)
    out32, _ = make_synthesis_fn(cfg32, params, device="cuda", **kw)(*inputs1c)
    style32 = style_latent(cfg32, params, inputs1c, device="cuda",
                           n_steps=sv.n_steps, guidance=sv.guidance)
    check_no_plain_on_card("multi-step fp32 card path")
    style_err = (style32.cpu() - ref_style).abs().max().item()
    same_dur = bool(torch.equal(out32.durations.cpu(), ref_out.durations))
    mel_err = (out32.mel.cpu() - ref_out.mel).abs().max().item()
    print(f"  fp32 card vs fp32 CPU plain path, batch 2 (text lengths "
          f"{inputs1[1].tolist()}), {sv.n_steps} steps: style latent before "
          f"quantisation max_abs_err {style_err:.2e} (tol {STYLE_TOL:.0e}; "
          f"max |style| {ref_style.abs().max().item():.2f}), durations "
          f"equal: {same_dur}, mel max_abs_err {mel_err:.2e} (tol "
          f"{FP32_PATH_TOL:.0e}; CPU runs {t_cpu:.1f} s)")
    if not style_err <= STYLE_TOL:
        raise AssertionError(f"fp32 multi-step card path vs CPU: style "
                             f"latent {style_err}")
    if not same_dur:
        raise AssertionError("fp32 multi-step card durations differ from "
                             "the CPU's")
    if not mel_err <= FP32_PATH_TOL:
        raise AssertionError(f"fp32 multi-step card path vs CPU: mel "
                             f"{mel_err}")
    return res


def longform_config() -> Config:
    """Acceptance level 4 read by the port's own ``load_config`` (batch 4,
    4864 frames, 1-step, with the vocoder, bf16) with ``bench.py``'s 256
    phonemes in place of the default 512."""
    cfg = load_config(str(LONGFORM_CONFIG))
    sv, m = cfg.serve, cfg.model
    if not (sv.one_step and sv.with_vocoder) or m.max_frames != 4864 or \
            sv.batch_size != 4 or cfg.runtime.compute_dtype != "bfloat16":
        raise AssertionError(f"{LONGFORM_CONFIG.name}: expected level 4, got "
                             f"{sv}, max_frames {m.max_frames}")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, max_text_len=base_config(full=True).model.max_text_len))


def phase_longform(card: str) -> dict:
    cfg = longform_config()
    m, sv = cfg.model, cfg.serve
    params = init_params(cfg, seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(
        LONGFORM_DURATION_BIAS)
    n_up = int(np.prod(m.vocoder.upsample_rates))
    res = {}
    for frames in (m.max_frames, 2048):
        fn = make_synthesis_fn(cfg, params, n_frames=frames, device="cuda")
        inputs = synth_inputs(cfg, sv.batch_size, "cuda")
        fn(*inputs)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_calls = 5
        r = drive_main_path(cfg, fn, inputs, device="cuda", n_calls=n_calls,
                            n_frames=frames)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        audio_s = (sv.batch_size * (frames * n_up - 1) * m.vocoder.istft_hop
                   / m.audio.sample_rate)
        ms = [t * 1e3 for t in r["times"]]
        lens = r["out"].frame_lengths
        print(f"  batch {sv.batch_size} x {frames} frames: "
              f"{r['seconds'] * 1e3:.1f} ms/call (median of {n_calls}, min "
              f"{min(ms):.1f}, max {max(ms):.1f}), frames "
              f"{int(lens.min())}..{int(lens.max())} of {frames}, waveform "
              f"{tuple(r['wav'].shape)} finite, audio-s/s "
              f"{audio_s / r['seconds']:.1f} ({audio_s:.1f} audio-s per "
              f"call), peak memory {peak_gb:.2f} GB  [{card}]")
        print(f"  kernel launches per call: "
              f"{ {k: n / n_calls for k, n in r['counts'].items()} } "
              f"(expected {r['per_call']})")
        res[frames] = {**r, "fn": fn, "inputs": inputs, "n_calls": n_calls}
    # fp32 on the card (the kernels) against fp32 on the CPU (the plain
    # versions), the same weights and inputs, batch 1 at 4864 frames
    cfg32 = dataclasses.replace(cfg, runtime=RuntimeConfig(
        compute_dtype="float32"))
    inputs1 = synth_inputs(cfg, 1, "cpu")
    t0 = time.perf_counter()
    ref_out, ref_wav = make_synthesis_fn(cfg32, params, device="cpu")(*inputs1)
    t_cpu = time.perf_counter() - t0
    out32, wav32 = make_synthesis_fn(cfg32, params, device="cuda")(
        *(x.cuda() for x in inputs1))
    check_no_plain_on_card("long-form fp32 card path")
    same_dur = bool(torch.equal(out32.durations.cpu(), ref_out.durations))
    mel_err = (out32.mel.cpu() - ref_out.mel).abs().max().item()
    wav_err = (wav32.cpu() - ref_wav).abs().max().item()
    print(f"  fp32 card vs fp32 CPU plain path, batch 1 x {m.max_frames} "
          f"frames ({int(ref_out.frame_lengths[0])} filled): durations equal: "
          f"{same_dur}, mel max_abs_err {mel_err:.2e} (tol "
          f"{FP32_PATH_TOL:.0e}), waveform max_abs_err {wav_err:.2e} "
          f"(max |wav| {ref_wav.abs().max().item():.3f}; CPU run "
          f"{t_cpu:.1f} s)")
    if not same_dur:
        raise AssertionError("fp32 long-form card durations differ from the "
                             "CPU's")
    if not mel_err <= FP32_PATH_TOL:
        raise AssertionError(f"fp32 long-form card path vs CPU: mel {mel_err}")
    return res


# ---------------------------------------------------------------------------
# the stage-1 train step
# ---------------------------------------------------------------------------

def train_config() -> Config:
    """The full-width model (147.6 M parameters, 256 phonemes) with
    ``TrainConfig``'s defaults: batch 16, dropout 0.1, bf16 compute."""
    return base_config(full=True)


def train_expected_counts(cfg: Config, n_frames: int) -> dict:
    """Kernel calls of one stage-1 step.  The generator step: the aligner's
    text encoder, the style extractor (reconstruction and the
    FSQ entropy term), the text-to-mel encoders, the prompt encoder for each
    speaker view, each with full attention; the decoder's blocks through
    the training kernels (rows 3-5 per attention block; row 6 twice and row
    7 twice per AdaIN block); the vocoder's transposed convs and head.  The
    discriminator step: the generator's forward under no_grad (row 1, row 6
    twice per block, the vocoder), with the aligner's text encoder only
    when MAS recomputes the durations (``use_mas_durations``)."""
    m, t = cfg.model, cfg.train
    d, v = m.decoder, m.vocoder
    n_attn = sum(1 for i in range(d.n_blocks) if (i + 1) % d.attn_every == 0)
    enc = m.text_encoder.n_attn_layers + m.prosody_encoder.n_layers
    ext = m.style.extractor_layers + 2
    views = 0
    if t.w_spk > 0:
        views = 2 + (t.w_spk_rec > 0) + (t.w_spk_voc > 0)
    aligner = m.text_encoder.n_attn_layers
    g_full = ((aligner if t.w_align > 0 or t.use_mas_durations else 0)
              + enc + ext
              + views * (m.prompt_encoder.n_layers + 1)
              + (ext if t.w_fsq_entropy > 0 else 0))
    d_full = (aligner if t.use_mas_durations else 0) + enc + ext
    expect = {"full_attention": g_full + d_full,
              "adain_conv": 4 * d.n_blocks,
              "adain_conv_bwd_data": 2 * d.n_blocks,
              "conv_transpose": 2 * len(v.upsample_rates),
              "synthesis_head": 2}
    twins = {"full_attention": g_full,
             "conv_transpose": len(v.upsample_rates), "synthesis_head": 1}
    if n_frames > d.attn_window:
        expect.update(local_attention=n_attn, local_attention_fwd_lse=n_attn,
                      local_attention_bwd_dq=n_attn,
                      local_attention_bwd_dkv=n_attn)
    else:
        expect["full_attention"] += 2 * n_attn
        twins["full_attention"] += n_attn
    return {"kernels": expect, "twins": twins}


def drive_train(cfg: Config, trainer, state, batch, *, device,
                n_steps: int, expect: dict | None = None,
                label: str = "stage-1 train step") -> dict:
    """``n_steps`` train steps, each timed to its end, with the kernel
    counts set to 0 just before and read just after: every kernel of the
    step launched as often as ``expect`` says (by default the stage-1
    step's counts) and no other, the twin backwards as expected, on the
    card no plain version, every loss finite."""
    device = torch.device(device)
    if expect is None:
        expect = train_expected_counts(cfg, batch["f0"].shape[1])
    if device.type == "cuda":
        torch.cuda.synchronize()
    times = []
    reset_counts()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kernel_counts(device)
    twins = dict(plain.twin_vjp_calls)
    if device.type == "cuda":
        check_no_plain_on_card(label)
    per = expect["kernels"]
    wrong = [f"{name}: {n} calls in {n_steps} steps, expected "
             f"{per.get(name, 0)} each" for name, n in counts.items()
             if n != per.get(name, 0) * n_steps]
    wrong += [f"twin backward {name}: {twins.get(name, 0)} in {n_steps} "
              f"steps, expected {n} each" for name, n in
              expect["twins"].items() if twins.get(name, 0) != n * n_steps]
    if wrong:
        raise AssertionError("; ".join(wrong))
    losses = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in losses.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: losses not finite: {bad}")
    return {"seconds": float(np.median(times)), "times": times,
            "counts": counts, "twins": twins, "per_step": per,
            "losses": losses, "state": state}


def _no_dropout(cfg: Config) -> Config:
    """The three dropout rates at 0 (the parity runs' setting)."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, text_encoder=dataclasses.replace(m.text_encoder, dropout=0.0),
        prosody_encoder=dataclasses.replace(m.prosody_encoder, dropout=0.0),
        predictor=dataclasses.replace(m.predictor, dropout=0.0)))


def train_parity_run(cfg: Config, params, nb, device, mesh=None) -> dict:
    """One fp32 generator and discriminator loss with their gradients on
    ``device``, the FSQ codes of the ground-truth mel, the predicted
    durations and (with ``use_mas_durations``) MAS's, at the initial
    weights.  With ``mesh`` each data rank takes its rows of ``nb``: the
    losses and gradients are the global batch's, the codes and durations
    gathered over the ranks."""
    tr = Stage1Trainer(cfg, params, device=device, mesh=mesh)
    state = tr.init_state(params)
    batch = batch_to_device(nb, device, sharding=None if mesh is None
                            else mesh_lib.batch_sharding(mesh))
    tr.load(state.g_params, state.d_params)
    _, g_aux, g_grads = tr.g_grads(batch)
    g_grads = tr.whole(g_grads)      # a tensor-parallel rank's chunks
    _, d_aux, d_grads = tr.d_grads(batch)
    ac, m = tr.acoustic, cfg.model
    with torch.no_grad():
        mas = (tr._forward_g(batch, None)[6].cpu()
               if cfg.train.use_mas_durations else None)
        n_frames = batch["f0"].shape[1]
        mel = stft_ops.mel_spectrogram(batch["wav"], m.audio)[:, :n_frames]
        frame_mask = length_mask(batch["frame_lengths"], n_frames)
        text_mask = length_mask(batch["text_lengths"],
                                batch["phonemes"].shape[1])
        styled, _, indices = ac.extract_style(mel, frame_mask)
        _, pros = ac.encode_text(batch["phonemes"], text_mask)
        durations = ac.duration_predictor.to_frames(ac.duration_predictor(
            pros, styled.mean(dim=1), mask=text_mask), text_mask)
        if mesh is not None:
            indices = collectives.gather_rows(mesh, indices)
            durations = collectives.gather_rows(mesh, durations)
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
    return {"losses": {k: v.item() for k, v in {**g_aux, **d_aux}.items()},
            "grads": {**{f"{p}.{k}": v for p, sd in g_grads.items()
                         for k, v in cpu(sd).items()},
                      **{f"discriminator.{k}": v
                         for k, v in cpu(d_grads).items()}},
            "indices": indices.cpu(), "durations": durations.cpu(),
            "mas": mas}


def check_train_parity(card: str, cfg: Config, params) -> None:
    """fp32 on the card (the kernels, TF32 off) against fp32 on the CPU
    (the plain versions), dropout 0, full width, batch 2 x 1024 frames with
    two different frame lengths: FSQ codes, predicted durations and (with
    ``use_mas_durations``) MAS's equal, each loss term within LOSS_RTOL,
    each gradient tensor within GRAD_RTOL of its largest value (plus
    GRAD_FLOOR of its model's largest)."""
    cfg32 = dataclasses.replace(_no_dropout(cfg), runtime=RuntimeConfig(
        compute_dtype="float32"))
    nb = train_batch(cfg, 2, PARITY_SEED)
    if nb.frame_lengths[0] == nb.frame_lengths[1]:
        raise AssertionError(f"parity batch: equal frame lengths "
                             f"{nb.frame_lengths}")
    t0 = time.perf_counter()
    ref = train_parity_run(cfg32, params, nb, "cpu")
    t_cpu = time.perf_counter() - t0
    reset_counts()
    got = train_parity_run(cfg32, params, nb, "cuda")
    check_no_plain_on_card("fp32 stage-1 card step")
    if not torch.equal(got["indices"], ref["indices"]):
        raise AssertionError("fp32 train step: FSQ codes differ from the "
                             "CPU's")
    if not torch.equal(got["durations"], ref["durations"]):
        raise AssertionError("fp32 train step: predicted durations differ "
                             "from the CPU's")
    mas = ""
    if cfg.train.use_mas_durations:
        if not torch.equal(got["mas"], ref["mas"]):
            raise AssertionError("fp32 train step: MAS durations differ from "
                                 "the CPU's")
        mas = " MAS durations equal;"
    gate_losses_and_grads(
        f"fp32 card vs fp32 CPU plain path, batch 2 x {TRAIN_FRAMES} frames "
        f"(frame lengths {nb.frame_lengths.tolist()}), dropout 0: FSQ codes "
        f"equal, predicted durations equal;{mas}", got, ref, t_cpu, card)


def gate_losses_and_grads(head: str, got: dict, ref: dict, t_cpu: float,
                          card: str) -> None:
    """Each loss term of ``got`` within LOSS_RTOL of ``ref``'s, each
    gradient tensor within GRAD_RTOL of its largest value plus GRAD_FLOOR of
    its model's largest (the part before the first dot of its name); print
    the worst term and the worst tensors, raise on any beyond."""
    loss_err = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-30) if v
                else abs(got["losses"][k]) for k, v in ref["losses"].items()}
    worst_loss = max(loss_err, key=loss_err.get)
    scale = {}
    for name, g in ref["grads"].items():
        part = name.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), g.abs().max().item())
    ratios, n_over = {}, 0
    for name, g in ref["grads"].items():
        err = (got["grads"][name] - g).abs().max().item()
        floor = GRAD_FLOOR * scale[name.split(".")[0]]
        top = g.abs().max().item()
        allowed = GRAD_RTOL * top + floor
        ratios[name] = err / allowed if allowed > 0 else (0.0 if err == 0
                                                          else np.inf)
        n_over += err > 1e-3 * top + floor
    worst = sorted(ratios, key=ratios.get, reverse=True)[:3]
    print(f"  {head} worst loss term {worst_loss} rel err "
          f"{loss_err[worst_loss]:.2e} (tol {LOSS_RTOL:.0e}); {len(ratios)} "
          f"gradient tensors, worst err/allowed "
          f"{', '.join(f'{k} {ratios[k]:.3f}' for k in worst)} (allowed "
          f"{GRAD_RTOL:.0e} * max|g| + {GRAD_FLOOR:.0e} * the model's "
          f"max|g|; {n_over} tensors above 1e-3 * max|g|; CPU run "
          f"{t_cpu:.1f} s)  [{card}]")
    bad = [k for k, e in loss_err.items() if not e <= LOSS_RTOL]
    if bad:
        raise AssertionError(f"{head} loss terms {bad}: "
                             f"{ {k: loss_err[k] for k in bad} }")
    bad = [k for k, r in ratios.items() if not r <= 1.0]
    if bad:
        raise AssertionError(f"{head} gradients {bad[:10]}")


def report_train(cfg: Config, r: dict, n_steps: int, what: str,
                 card: str) -> None:
    """Print a train phase's step times, audio-s trained per s, peak memory
    (since the last reset), losses, launches and twin backwards per step."""
    m, t = cfg.model, cfg.train
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    audio_s = t.batch_size * TRAIN_FRAMES * m.audio.hop_length \
        / m.audio.sample_rate
    ms = [x * 1e3 for x in r["times"]]
    print(f"  batch {t.batch_size} x {TRAIN_FRAMES} frames ({TRAIN_TEXT} "
          f"phonemes), {what}: {r['seconds'] * 1e3:.1f} ms/step "
          f"(median of {n_steps}, min {min(ms):.1f}, max {max(ms):.1f}), "
          f"{audio_s / r['seconds']:.1f} audio-s trained per s ({audio_s:.1f} "
          f"audio-s per step), peak memory {peak_gb:.2f} GB  [{card}]")
    print(f"  losses of the last step: "
          f"{ {k: round(v, 5) for k, v in r['losses'].items()} }")
    print(f"  kernel launches per step: "
          f"{ {k: n / n_steps for k, n in r['counts'].items()} } (expected "
          f"{r['per_step']}); twin backwards per step "
          f"{ {k: n / n_steps for k, n in r['twins'].items()} }; plain "
          f"versions on the card: {sum(plain.cuda_calls.values())}")


def train_batch(cfg: Config, batch_size: int, seed: int):
    """A synthetic batch of ``TRAIN_FRAMES`` frames and ``TRAIN_TEXT``
    phonemes (numpy)."""
    return SyntheticDataset(cfg.model, batch_size=batch_size, seed=seed,
                            n_frames=TRAIN_FRAMES, text_len=TRAIN_TEXT) \
        .next_batch()


def run_train_phase(card: str, cfg: Config, trainer, state, batch,
                    expect: dict, label: str, n_steps: int = 5) -> dict:
    """One warm-up step, then ``n_steps`` through ``drive_train`` with the
    peak memory reset between, and the report."""
    state, _ = trainer.train_step(state, batch)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = drive_train(cfg, trainer, state, batch, device="cuda",
                    n_steps=n_steps, expect=expect, label=label)
    report_train(cfg, r, n_steps, label, card)
    step_state = r["state"]
    return {"counts": r["counts"], "n_calls": n_steps,
            "seconds": r["seconds"],
            "fn": lambda: trainer.train_step(step_state, batch),
            "inputs": ()}


def phase_train(card: str) -> dict:
    """The stage-1 step at batch 16 x 1024 frames, bf16, dropout on: one
    warm-up step, then the median of 5, the launches per step, peak memory
    and the loss terms; then the fp32 card-vs-CPU check."""
    cfg = train_config()
    t = cfg.train
    params = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    params["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    trainer = Stage1Trainer(cfg, params, device="cuda", seed=0)
    batch = batch_to_device(train_batch(cfg, t.batch_size, 0), "cuda")
    res = run_train_phase(card, cfg, trainer, trainer.init_state(params),
                          batch, train_expected_counts(cfg, TRAIN_FRAMES),
                          "stage-1 step (bf16, dropout on)")
    # the forward-sum loss alone at the step's lattice: its loop over the
    # frames is launch-bound
    from torch.profiler import ProfilerActivity, profile
    lp = torch.randn(t.batch_size, TRAIN_FRAMES, TRAIN_TEXT, device="cuda") \
        .log_softmax(-1).requires_grad_()

    def fsum():
        align_ops.forward_sum_loss(lp, batch["text_lengths"],
                                   batch["frame_lengths"]).backward()
    fsum()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fsum()
    torch.cuda.synchronize()
    fsum_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fsum()
        torch.cuda.synchronize()
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"  forward-sum loss alone ({t.batch_size} x {TRAIN_FRAMES} frames "
          f"x {TRAIN_TEXT} phonemes), forward + backward: {fsum_ms:.1f} ms, "
          f"{n_launch} kernel launches  [{card}]")
    check_train_parity(card, cfg, params)
    return res


# ---------------------------------------------------------------------------
# stages 2 and 3: the style-diffusion step and the 1-step distillation
# ---------------------------------------------------------------------------

def stage2_expected_counts(cfg: Config) -> dict:
    """Kernel calls of one stage-2 step: the frozen style extractor, prompt
    encoder (with its pooling) and text encoder, forward only (row 2,
    bf16); one denoiser call on the batch with grad (row 2, fp32: each
    block's self- and cross-attention, each with a twin backward)."""
    m = cfg.model
    den = 2 * m.diffusion.n_layers
    frozen = (m.style.extractor_layers + 2 + m.prompt_encoder.n_layers + 1
              + m.text_encoder.n_attn_layers)
    return {"kernels": {"full_attention": frozen + den},
            "twins": {"full_attention": den}}


def stage3_expected_counts(cfg: Config, n_frames: int,
                           n_teacher_steps: int) -> dict:
    """Kernel calls of one stage-3 step: the frozen prompt and text
    encoders (row 2, bf16); the teacher's sampler under no_grad (its
    denoiser calls through row 2 fp32, rows 8-9 as ``sampler_calls``
    counts them); the student's one denoiser call with grad (row 2 fp32,
    twin backwards); the teacher's decode (row 1, row 6 twice a block) and
    the student's with its backward (rows 3-5, row 6 twice and row 7 twice
    a block), or full attention where the frames fit in one chunk."""
    m = cfg.model
    d = m.decoder
    n_attn = sum(1 for i in range(d.n_blocks) if (i + 1) % d.attn_every == 0)
    n_den, n_euler, n_heun = sampler_calls(cfg, False, n_teacher_steps)
    den = 2 * m.diffusion.n_layers
    expect = {"full_attention": (m.prompt_encoder.n_layers + 1
                                 + m.text_encoder.n_attn_layers
                                 + m.prosody_encoder.n_layers
                                 + den * (n_den + 1)),
              "sampler_euler": n_euler, "sampler_heun": n_heun,
              "adain_conv": 4 * d.n_blocks,
              "adain_conv_bwd_data": 2 * d.n_blocks}
    twins = {"full_attention": den}
    if n_frames > d.attn_window:
        expect.update(local_attention=n_attn, local_attention_fwd_lse=n_attn,
                      local_attention_bwd_dq=n_attn,
                      local_attention_bwd_dkv=n_attn)
    else:
        expect["full_attention"] += 2 * n_attn
        twins["full_attention"] += n_attn
    return {"kernels": expect, "twins": twins}


def diffusion_train_params(cfg: Config) -> dict:
    """Seed-0 weights with ``DURATION_BIAS`` and the denoiser's AdaLN gates
    drawn (``with_denoiser_gates``), so that every block reaches the
    loss."""
    params = init_params(cfg, seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    return with_denoiser_gates(params)


def diffusion_parity_run(trainer, params, nb, device, **draws) -> dict:
    """One fp32 loss of ``trainer`` (a stage-2 or stage-3 trainer on
    ``device``) with its denoiser gradients, at the initial weights, on
    ``draws`` moved to the device."""
    trainer.load(trainer.init_state(params["diffusion"]).params)
    _, aux, grads = trainer.grads(
        batch_to_device(nb, device),
        **{k: v.to(device) for k, v in draws.items()})
    return {"losses": {k: v.item() for k, v in aux.items() if v.ndim == 0},
            "grads": {f"diffusion.{k}": v.cpu() for k, v in grads.items()},
            "aux": {k: v.cpu() for k, v in aux.items() if v.ndim > 0}}


def check_diffusion_parity(card: str, cfg: Config, label: str, make,
                           params, draws: dict) -> dict:
    """fp32 on the card (the kernels, TF32 off) against fp32 on the CPU (the
    plain versions), batch 2 x ``TRAIN_FRAMES`` with two frame lengths, the
    same draws on both sides: the loss terms and the denoiser's gradients
    through ``gate_losses_and_grads``.  ``make(device)`` builds the
    trainer.  Returns both runs' non-scalar outputs."""
    nb = train_batch(cfg, 2, PARITY_SEED)
    t0 = time.perf_counter()
    ref = diffusion_parity_run(make("cpu"), params, nb, "cpu", **draws)
    t_cpu = time.perf_counter() - t0
    reset_counts()
    got = diffusion_parity_run(make("cuda"), params, nb, "cuda", **draws)
    check_no_plain_on_card(f"fp32 {label} card step")
    checks = []
    for k, v in ref["aux"].items():
        if not torch.equal(got["aux"][k], v):
            raise AssertionError(f"fp32 {label}: {k} differ from the CPU's")
        checks.append(f"{k} equal")
    gate_losses_and_grads(
        f"fp32 {label}, card vs CPU plain path, batch 2 x {TRAIN_FRAMES} "
        f"frames (frame lengths {nb.frame_lengths.tolist()}):"
        + "".join(f" {c};" for c in checks), got, ref, t_cpu, card)
    return {"ref": ref, "got": got}


def phase_train_stage2(card: str) -> dict:
    """The stage-2 step (``Stage2Trainer``) at batch 16 x 1024 frames, the
    acoustic model frozen in bf16, the denoiser fp32; then fp32 card vs
    CPU at batch 2 on the same draws (one prompt dropped of two)."""
    cfg = train_config()
    m = cfg.model
    params = diffusion_train_params(cfg)
    trainer = Stage2Trainer(cfg, params, device="cuda", seed=0)
    batch = batch_to_device(train_batch(cfg, cfg.train.batch_size, 0), "cuda")
    res = run_train_phase(card, cfg, trainer,
                          trainer.init_state(params["diffusion"]), batch,
                          stage2_expected_counts(cfg),
                          "stage-2 step (acoustic bf16 frozen, denoiser fp32)")
    cfg32 = dataclasses.replace(cfg, runtime=RuntimeConfig(
        compute_dtype="float32"))
    g = torch.Generator().manual_seed(PARITY_SEED)
    draws = {"drop": torch.tensor([False, True]),
             "n": torch.randn(2, generator=g),
             "noise": torch.randn(2, m.style.n_codes, m.style.d_style,
                                  generator=g)}
    check_diffusion_parity(
        card, cfg, "stage-2 loss", lambda dev: Stage2Trainer(cfg32, params,
                                                        device=dev),
        params, draws)
    return res


STAGE3_PARITY_STEPS = 4


def phase_train_stage3(card: str) -> dict:
    """The stage-3 step (``Stage3Trainer``: 16 teacher steps, guidance 3)
    at batch 16 x 1024 frames, the acoustic model frozen in bf16; then
    fp32 card vs CPU at batch 2 with ``STAGE3_PARITY_STEPS`` teacher steps
    (so the CPU reference stays short) on the same noise: both decodes'
    predicted durations equal, the loss terms and gradients gated."""
    cfg = train_config()
    m, dc = cfg.model, cfg.model.diffusion
    params = diffusion_train_params(cfg)
    trainer = Stage3Trainer(cfg, params, device="cuda", seed=0)
    if trainer.n_teacher_steps != 16 or dc.cfg_scale != 3.0:
        raise AssertionError(f"stage 3: {trainer.n_teacher_steps} teacher "
                             f"steps, guidance {dc.cfg_scale}")
    batch = batch_to_device(train_batch(cfg, cfg.train.batch_size, 0), "cuda")
    res = run_train_phase(
        card, cfg, trainer, trainer.init_state(params["diffusion"]), batch,
        stage3_expected_counts(cfg, TRAIN_FRAMES, trainer.n_teacher_steps),
        f"stage-3 step ({trainer.n_teacher_steps} teacher steps, guidance "
        f"{dc.cfg_scale}, acoustic bf16 frozen, student fp32)")
    cfg32 = dataclasses.replace(cfg, runtime=RuntimeConfig(
        compute_dtype="float32"))
    g = torch.Generator().manual_seed(PARITY_SEED)
    noise = torch.randn(2, m.style.n_codes, m.style.d_style, generator=g)
    check_diffusion_parity(
        card, cfg, f"stage-3 loss ({STAGE3_PARITY_STEPS} teacher steps)",
        lambda dev: Stage3Trainer(cfg32, params, device=dev,
                                  n_teacher_steps=STAGE3_PARITY_STEPS),
        params, {"noise": noise})
    return res


# ---------------------------------------------------------------------------
# the corpus path: the native frontend, MAS, the stage-1 step from an
# unannotated corpus, the evaluations and ``train --corpus``
# ---------------------------------------------------------------------------

# export_synthetic_corpus's corpus: 48 utterances of 8 speakers, each 1024
# frames (12.8 s) and up to 256 phonemes; the loaders split it into three
# shards of 16, one for training and one held out for the evaluations.
CORPUS_UTTS, CORPUS_SPEAKERS, CORPUS_SHARDS = 48, 8, 3
MAS_RUNS = 5
# The evaluations, fp32 on the card (TF32 off) against fp32 on the CPU at
# batch 2 on the same inputs and noise: every float metric (means over a
# 1024-frame decode or a style latent, rounded to at most 5 decimals, and
# the similarity of two embeddings) within EVAL_ATOL, as FP32_PATH_TOL holds
# the mel; the counts and rates (durations, FSQ codes, retrievals) equal.
EVAL_ATOL = 1e-3
EVAL_EXACT = frozenset({"dur_mae_frames", "dur_exact_match",
                        "fsq_code_match_rate", "style_latent_mse_seeds",
                        "retrieval_acc", "retrieval_chance"})


def export_corpora(cfg: Config, root: Path) -> tuple[str, str]:
    """``export_synthetic_corpus`` at ``TRAIN_FRAMES`` and ``TRAIN_TEXT``
    into ``root/annotated``, and ``root/unannotated``: the same wavs with
    every ``"durations"`` key dropped from the metadata (the case MAS
    exists for)."""
    ann, una = root / "annotated", root / "unannotated"
    corpus_lib.export_synthetic_corpus(
        str(ann), cfg.model, n_utts=CORPUS_UTTS, n_speakers=CORPUS_SPEAKERS,
        n_frames=TRAIN_FRAMES, text_len=TRAIN_TEXT, seed=0)
    una.mkdir()
    (una / "wavs").symlink_to(ann / "wavs")
    recs = [json.loads(x) for x in
            (ann / "metadata.jsonl").read_text().splitlines() if x]
    for rec in recs:
        del rec["durations"]
    (una / "metadata.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    return str(ann), str(una)


def check_frontend(cfg: Config, root: str, card: str) -> None:
    """Fail unless F0 takes the port's native library; print the ms of
    ``featurize`` on one 1024-frame utterance on the native and the numpy
    route and their F0 agreement."""
    if not native_frontend.available() or \
            audio_utils._native() is not native_frontend:
        raise AssertionError("the native frontend is not built or not the "
                             "route of estimate_f0")
    m = cfg.model
    src = corpus_lib.DiskCorpus(root, m, n_frames=TRAIN_FRAMES,
                                text_len=TRAIN_TEXT)
    e = src.entries[0]
    utt = Utterance(e.phonemes, src._load_wav(e.wav_path), e.durations)
    hop, fl = m.audio.hop_length, min(m.audio.win_length,
                                      4 * m.audio.hop_length)

    def feat_ms():
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            featurize(utt, m, n_frames=TRAIN_FRAMES, text_len=TRAIN_TEXT)
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    native_ms = feat_ms()
    f0_cc, v_cc = audio_utils.estimate_f0(utt.wav, m.audio.sample_rate,
                                          hop=hop, frame_length=fl)
    route = audio_utils._native
    audio_utils._native = lambda: None      # the numpy twin
    try:
        numpy_ms = feat_ms()
        f0_np, v_np = audio_utils.estimate_f0(utt.wav, m.audio.sample_rate,
                                              hop=hop, frame_length=fl)
    finally:
        audio_utils._native = route
    both = v_cc & v_np
    rel = np.abs(f0_cc[both] - f0_np[both]) / f0_np[both]
    print(f"  native frontend {native_frontend.library_path().name}; "
          f"featurize one {TRAIN_FRAMES}-frame utterance: native "
          f"{native_ms:.1f} ms, numpy {numpy_ms:.1f} ms (median of 3); F0 "
          f"voicing agrees on {100 * (v_cc == v_np).mean():.1f} % of "
          f"{len(v_cc)} frames, F0 on both-voiced frames within "
          f"{rel.max():.2e} relative (host: the card machine's CPU)  [{card}]")


def _profiled_launches(fn) -> int:
    """Device kernel events of one call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def check_mas(trainer, batch, card: str) -> None:
    """MAS alone at the step's lattice: fp32 energies of the aligner's
    forward on a corpus batch; the card's durations equal to the CPU's on
    the same energies and summing to the frame lengths; the median ms of
    ``MAS_RUNS`` runs and the launches of one."""
    ac, m = trainer.acoustic, trainer.cfg.model
    with torch.no_grad():
        n_frames = batch["f0"].shape[1]
        mel = stft_ops.mel_spectrogram(batch["wav"], m.audio)[:, :n_frames]
        text_mask = length_mask(batch["text_lengths"],
                                batch["phonemes"].shape[1])
        energies = ac.align_energies(
            ac.text_encoder(batch["phonemes"], mask=text_mask), mel,
            text_mask=text_mask)
    if energies.dtype != torch.float32:
        raise AssertionError(f"aligner energies {energies.dtype}")
    tl, fl = batch["text_lengths"], batch["frame_lengths"]

    def run():
        return align_ops.monotonic_alignment_search(energies, tl, fl)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(MAS_RUNS):
        t0 = time.perf_counter()
        dur = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n_launch = _profiled_launches(run)
    ref = align_ops.monotonic_alignment_search(energies.cpu(), tl.cpu(),
                                               fl.cpu())
    if not torch.equal(dur.cpu(), ref):
        raise AssertionError(f"MAS: the card's durations differ from the "
                             f"CPU's in {(dur.cpu() != ref).sum().item()} "
                             f"places")
    if not torch.equal(ref.sum(1), fl.cpu().to(torch.int32)):
        raise AssertionError("MAS durations do not sum to the frame lengths")
    B, T, N = energies.shape
    print(f"  MAS alone ({B} x {T} frames x {N} phonemes, fp32 energies of "
          f"the aligner on a corpus batch): {np.median(times):.1f} ms "
          f"(median of {MAS_RUNS}, min {min(times):.1f}, max "
          f"{max(times):.1f}), {n_launch} kernel launches a run; durations "
          f"equal to the CPU's, summing to the frame lengths  [{card}]")


def eval_calls(cfg: Config, params, batch, spk, noise, *, device,
               n_steps=None) -> tuple[dict, dict]:
    """The five evaluations on ``device``: ``evaluate_acoustic`` and
    ``fsq_usage_stats`` on ``batch``, ``speaker_similarity_margin`` of
    ``spk``'s wavs against its references (one utterance of each speaker),
    ``evaluate_diffusion`` (2 seeds, guidance 1) and
    ``evaluate_distill_gap`` (the denoiser as teacher and student) on
    ``noise``; ``n_steps`` the samplers' (default the config's).  Returns
    (reports, ms of each call)."""
    g = {"acoustic": params["acoustic"], "vocoder": params["vocoder"]}
    ac, df = params["acoustic"], params["diffusion"]
    calls = {
        "evaluate_acoustic": lambda: eval_lib.evaluate_acoustic(
            cfg, g, batch, device=device),
        "fsq_usage_stats": lambda: eval_lib.fsq_usage_stats(
            cfg, ac, batch, device=device),
        "speaker_similarity_margin":
            lambda: eval_lib.speaker_similarity_margin(
                cfg, ac, spk["wav"], spk["ref_wav"], device=device),
        "evaluate_diffusion": lambda: eval_lib.evaluate_diffusion(
            cfg, ac, df, batch, noise["diffusion"], n_steps=n_steps,
            n_seeds=2, guidance=1.0, device=device),
        "evaluate_distill_gap": lambda: eval_lib.evaluate_distill_gap(
            cfg, ac, df, df, batch, noise["distill"],
            n_teacher_steps=n_steps, device=device)}
    reps, ms = {}, {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        reps[name] = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    return reps, ms


def eval_noise(cfg: Config, batch_size: int, seed: int) -> dict:
    """The evaluations' initial noise on the CPU: two seeds for
    ``evaluate_diffusion``, one for ``evaluate_distill_gap``."""
    s = cfg.model.style
    g = torch.Generator().manual_seed(seed)
    draw = lambda: torch.randn(batch_size, s.n_codes, s.d_style,  # noqa: E731
                               generator=g)
    return {"diffusion": [draw(), draw()], "distill": draw()}


def compare_eval(got: dict, ref: dict) -> float:
    """Fail unless ``got``'s reports have ``ref``'s keys, the counts and
    rates (``EVAL_EXACT`` and all of ``fsq_usage_stats``) equal and every
    other number within ``EVAL_ATOL``; returns the largest float gap."""
    worst = 0.0
    for name, rep in ref.items():
        if set(got[name]) != set(rep):
            raise AssertionError(f"{name}: keys {sorted(got[name])}")
        for k, v in rep.items():
            g = got[name][k]
            if k in EVAL_EXACT or name == "fsq_usage_stats":
                if g != v:
                    raise AssertionError(f"{name} {k}: {g} vs the CPU's {v}")
                continue
            worst = max(worst, abs(g - v))
            if not abs(g - v) <= EVAL_ATOL:
                raise AssertionError(f"{name} {k}: {g} vs the CPU's {v} "
                                     f"(tol {EVAL_ATOL})")
    return worst


def speaker_batch(src) -> dict:
    """One utterance of each speaker of ``src`` (its first), collated."""
    first = {}
    for i, e in enumerate(src.entries):
        first.setdefault(e.speaker, i)
    return collate([src[i] for i in first.values()])


def phase_corpus(card: str) -> dict:
    """The corpus path at full width (``train_config()``, 147.6 M
    parameters, seed-0 weights with ``DURATION_BIAS``): (1) the native
    frontend; (2) the corpus and its unannotated copy; (3) MAS alone at
    16 x 1024 x 256; (4) the stage-1 step with ``use_mas_durations`` from
    the unannotated corpus (batch 16 x 1024, bf16, dropout on; batches from
    ``make_corpus_loader``): one warm-up step and the median of 5 with the
    launches the stage-1 phase counts plus the discriminator step's
    aligner, the loader's ms a batch; (5) fp32 card vs CPU on the stage-1
    phase's parity batch (2 x 1024, two frame lengths) with MAS on: MAS
    and predicted durations and FSQ codes equal, the loss terms and
    gradients gated; (6) the evaluations on a held-out batch of 16 (bf16,
    finite) and at batch 2 in fp32 against the CPU; (7) ``train --stage 1
    --corpus --steps 2`` with MAS on."""
    cfg = dataclasses.replace(train_config(), train=dataclasses.replace(
        train_config().train, use_mas_durations=True))
    m, t = cfg.model, cfg.train
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ann, una = export_corpora(cfg, Path(tmp))
        check_frontend(cfg, ann, card)

        loader_ms = []

        def pull(root, shard):
            it = iter(corpus_lib.make_corpus_loader(
                root, m, batch_size=t.batch_size, n_frames=TRAIN_FRAMES,
                text_len=TRAIN_TEXT, seed=0, worker_count=0,
                shard_index=shard, shard_count=CORPUS_SHARDS))
            t0 = time.perf_counter()
            b = next(it)
            loader_ms.append((time.perf_counter() - t0) * 1e3)
            return b

        nb = pull(una, 0)                       # the training shard
        if nb["durations"].any():
            raise AssertionError("the unannotated corpus gave durations")
        params = init_params(cfg, seed=0, device="cpu",
                             with_discriminator=True)
        params["acoustic"]["duration_predictor.out.bias"].fill_(
            DURATION_BIAS)
        trainer = Stage1Trainer(cfg, params, device="cuda", seed=0)
        batch = batch_to_device(nb, "cuda")
        check_mas(trainer, batch, card)
        torch.cuda.synchronize()
        step = run_train_phase(card, cfg, trainer, trainer.init_state(params),
                               batch, train_expected_counts(cfg, TRAIN_FRAMES),
                               "stage-1 step from the unannotated corpus, "
                               "MAS durations (bf16, dropout on)")
        res["train"] = step
        check_train_parity(card, cfg, params)
        del trainer, batch
        torch.cuda.empty_cache()

        held = pull(ann, 1)                     # held out from training
        print(f"  make_corpus_loader (worker_count 0, native F0): "
              f"{', '.join(f'{x:.0f}' for x in loader_ms)} ms for a batch "
              f"of {t.batch_size} x {TRAIN_FRAMES} frames, the step "
              f"{step['seconds'] * 1e3:.1f} ms (host: the card machine's "
              f"CPU)  [{card}]")
        spk = speaker_batch(corpus_lib.DiskCorpus(
            ann, m, n_frames=TRAIN_FRAMES, text_len=TRAIN_TEXT))
        eparams = with_denoiser_gates(params)
        torch.cuda.synchronize()
        reset_counts()
        reps, ms = eval_calls(cfg, eparams, held, spk,
                              eval_noise(cfg, t.batch_size, 0),
                              device="cuda")
        counts = kernel_counts(torch.device("cuda"))
        check_no_plain_on_card("the evaluations")
        if not np.isfinite(list(_numbers(reps))).all():
            raise AssertionError(f"an evaluation is not finite: {reps}")
        res["eval"] = {"counts": counts, "n_calls": 1}
        print(f"  evaluations (bf16, batch {t.batch_size} x {TRAIN_FRAMES} "
              f"frames, margin over {len(spk['wav'])} speakers, "
              f"{m.diffusion.n_steps} sampler steps): "
              f"{ {k: round(v, 1) for k, v in ms.items()} } ms; launches "
              f"{ {k: n for k, n in counts.items() if n} }  [{card}]")
        print(f"  reports: {json.dumps(reps)}")
        cfg32 = dataclasses.replace(cfg, runtime=RuntimeConfig(
            compute_dtype="float32"))
        two = {k: v[:2] for k, v in held.items()}
        spk2 = {k: v[:2] for k, v in spk.items()}
        noise2 = eval_noise(cfg, 2, PARITY_SEED)
        t0 = time.perf_counter()
        ref, _ = eval_calls(cfg32, eparams, two, spk2, noise2, device="cpu",
                            n_steps=STAGE3_PARITY_STEPS)
        t_cpu = time.perf_counter() - t0
        reset_counts()
        got, _ = eval_calls(cfg32, eparams, two, spk2, noise2, device="cuda",
                            n_steps=STAGE3_PARITY_STEPS)
        check_no_plain_on_card("fp32 evaluations")
        worst = compare_eval(got, ref)
        print(f"  fp32 evaluations, card vs CPU plain path at batch 2 "
              f"({STAGE3_PARITY_STEPS} sampler steps): counts and rates "
              f"equal, largest float gap {worst:.2e} (tol {EVAL_ATOL:.0e}); "
              f"CPU run {t_cpu:.1f} s  [{card}]")

        toml = Path(tmp) / "mas.toml"
        toml.write_text("[train]\nuse_mas_durations = true\n")
        work = Path(tmp) / "work"
        reset_counts()
        t0 = time.perf_counter()
        out = cli_stdout(["train", "--stage", "1", "--corpus", una,
                          "--steps", "2", "--config", str(toml),
                          "--workdir", str(work)])
        check_no_plain_on_card("train --corpus")
        tree = load_params(str(work / "stage1_final"))
        if set(tree) != {"g", "d"} or set(tree["g"]) != set(G_PARTS) or \
                not all(torch.isfinite(v).all() for part in tree["g"].values()
                        for v in part.values()):
            raise AssertionError(f"train --corpus wrote {sorted(tree)}")
        n_weights = sum(v.numel() for p in tree["g"].values()
                        for v in p.values())
        c = Config()
        print(f"  train --stage 1 --corpus (MAS, {c.train.batch_size} x "
              f"{min(c.model.max_frames, 256)} frames, 48 phonemes) "
              f"--steps 2: {time.perf_counter() - t0:.1f} s, stage1_final "
              f"loads back ({n_weights} generator weights, finite); last "
              f"line: "
              f"{out.strip().splitlines()[-1]}  [{card}]")
    return res


# ---------------------------------------------------------------------------
# serving (acceptance level 5) and the numerics gate (level 1)
# ---------------------------------------------------------------------------

def serve_config(*, with_vocoder: bool = False, batch: int = 32,
                 dtype: str = "bfloat16") -> Config:
    """Acceptance level 5 at full size (``acceptance.py:115-118`` and
    ``:159-162``): 256 phonemes, buckets of 256, 512 and 1024 frames, batch
    32, 1-step, mel only (with the vocoder, as ``configs/pod_v5e16.toml``
    serves, when asked), bf16."""
    return Config(model=ModelConfig(max_text_len=256, max_frames=1024),
                  runtime=RuntimeConfig(compute_dtype=dtype),
                  serve=ServeConfig(batch_size=batch, one_step=True,
                                    with_vocoder=with_vocoder,
                                    frame_buckets=(256, 512, 1024)))


def serve_requests(cfg: Config, n: int, *, seed: int = 0,
                   est_frames=None) -> list[Request]:
    """Level 5's draws (``acceptance.py:179-188``, ``default_rng(seed)``):
    for each request 3 s of reference noise, then its frame estimate in
    [32, max_frames) (or ``est_frames[i]``); then, from the same generator,
    random ARPAbet phonemes, as many as should fill the estimate at
    ``SERVE_FRAMES_PER_PHONEME`` (level 5's one fixed text would fill a
    few dozen frames of every bucket, and audio-s/s would measure padding)."""
    rng = np.random.default_rng(seed)
    sr = cfg.model.audio.sample_rate
    arpabet = text_utils.SYMBOLS[5:44]
    reqs = []
    for i in range(n):
        ref = rng.standard_normal(3 * sr).astype(np.float32) * 0.1
        est = int(rng.integers(32, cfg.model.max_frames))
        if est_frames is not None:
            est = int(est_frames[i])
        n_ph = int(np.clip(round(est / SERVE_FRAMES_PER_PHONEME) - 2, 1,
                           cfg.model.max_text_len - 2))
        ids = text_utils.phonemes_to_ids(
            [arpabet[j] for j in rng.integers(0, len(arpabet), n_ph)])
        reqs.append(Request(uid=i, phonemes=np.asarray(ids, np.int32),
                            ref_wav=ref, est_frames=est))
    return reqs


def serve_expected_counts(cfg: Config, plan, n_requests: int) -> dict:
    """Kernel launches of one ``serve_batch`` call as the bucket plan
    predicts: each bucket's batches run the synthesis path at the bucket's
    frames (bucket 256's decoder attention through row 2, longer ones
    through row 1), and the style exchange runs the prompt encoder once per
    chunk of 64 references."""
    expect: dict[str, int] = {}
    for bucket, n_batches in plan.batches_per_bucket.items():
        per = expected_counts(cfg, bucket, one_step=cfg.serve.one_step,
                              n_steps=cfg.serve.n_steps,
                              with_vocoder=cfg.serve.with_vocoder)
        for name, n in per.items():
            expect[name] = expect.get(name, 0) + n_batches * n
    n_chunks = -(-n_requests // Server._STYLE_CHUNK)
    expect["full_attention"] += n_chunks * (
        cfg.model.prompt_encoder.n_layers + 1)
    return expect


def drive_serve(server: Server, reqs: list[Request], *, n_calls: int,
                label: str, card: str) -> dict:
    """``n_calls`` ``serve_batch`` calls, each timed to its end, with the
    kernel counts set to 0 just before and read just after; check the
    launches against the bucket plan, no plain version on the card, no
    requeue, every request served once with a finite mel, and the batches
    served per bucket against the plan."""
    cfg = server.cfg
    s, a = cfg.serve, cfg.model.audio
    on_card = server.device.type == "cuda"
    plan = server.plan(reqs)
    expect = serve_expected_counts(cfg, plan, len(reqs))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    server.requeued = []
    times = []
    reset_counts()
    for _ in range(n_calls):
        t0 = time.perf_counter()
        results = server.serve_batch(reqs)
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kernel_counts(server.device)
    if on_card:
        check_no_plain_on_card(label)
    check_counts(label, counts, expect, n_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    est = {r.uid: r.est_frames for r in reqs}
    bucket_of = {uid: bucketing.bucket_for(e, s.frame_buckets)
                 for uid, e in est.items()}
    got: dict[int, int] = {}
    for r in results:
        got[bucket_of[r.uid]] = got.get(bucket_of[r.uid], 0) + 1
        if r.mel.shape != (r.frames, a.n_mels) or \
                not np.isfinite(r.mel).all():
            raise AssertionError(f"{label}: uid {r.uid} mel {r.mel.shape} "
                                 f"for {r.frames} frames, or not finite")
    served = {b: -(-n // s.batch_size) for b, n in sorted(got.items())}
    matches = served == plan.batches_per_bucket and not server.requeued
    if sorted(r.uid for r in results) != sorted(est) or not matches:
        raise AssertionError(f"{label}: served {len(results)} of {len(reqs)}, "
                             f"requeued {len(server.requeued)}, batches "
                             f"{served} against the plan "
                             f"{plan.batches_per_bucket}")
    sec = float(np.median(times))
    ms = [t * 1e3 for t in times]
    frames = [r.frames for r in results]
    full = sum(r.frames >= bucket_of[r.uid] for r in results)
    served_s = sum(frames) * a.hop_length / a.sample_rate
    padded_s = sum(bucket_of[r.uid] for r in results) * a.hop_length \
        / a.sample_rate
    print(f"  {label}: {len(reqs)} requests, {sec * 1e3:.1f} ms/call "
          f"(median of {n_calls}, min {min(ms):.1f}, max {max(ms):.1f}), "
          f"{len(reqs) / sec:.1f} requests/s, served audio-s/s "
          f"{served_s / sec:.1f} ({served_s:.1f} audio-s a call), padded "
          f"audio-s/s {padded_s / sec:.1f} ({padded_s:.1f} s of buckets), "
          f"peak memory {peak_gb:.2f} GB  [{card}]")
    print(f"    frames {min(frames)}..{max(frames)}; {full} requests filled "
          f"or overflowed their bucket; plan_batches "
          f"{dict(sorted(plan.batches_per_bucket.items()))}, served_batches "
          f"{served}, plan_matches_served {matches}, requeued "
          f"{len(server.requeued)}; kernel launches per call "
          f"{ {k: n / n_calls for k, n in counts.items() if n} } (as the "
          f"plan predicts); no plain version on the card")
    return {"counts": counts, "n_calls": n_calls, "results": results,
            "seconds": sec}


def check_serve_parity(card: str, params) -> None:
    """fp32 on the card (the kernels, TF32 off) against fp32 on the CPU
    (the plain versions): 8 requests over the 256 and 512 buckets at batch
    4, the same weights, requests and initial noise (the two devices'
    generators draw different numbers from one seed).  Per uid the frames
    equal and the mel within ``FP32_PATH_TOL``; the style table within
    ``STYLE_TOL``; the dispatch order equal."""
    cfg = serve_config(batch=4, dtype="float32")
    st = cfg.model.style
    reqs = serve_requests(cfg, 8, seed=PARITY_SEED,
                          est_frames=(150, 480, 200, 300, 100, 500, 250, 400))
    noise = torch.randn(cfg.serve.batch_size, st.n_codes, st.d_style,
                        generator=torch.Generator().manual_seed(PARITY_SEED))
    t0 = time.perf_counter()
    cpu = Server(cfg, params, device="cpu", noise=noise)
    ref = cpu.serve_batch(reqs)
    t_cpu = time.perf_counter() - t0
    reset_counts()
    card_server = Server(cfg, params, device="cuda", noise=noise)
    got = card_server.serve_batch(reqs)
    check_no_plain_on_card("serve fp32 card path")
    if cpu.requeued or card_server.requeued:
        raise AssertionError("serve fp32 parity: a batch was requeued")
    order, ref_order = [r.uid for r in got], [r.uid for r in ref]
    style_err = float(np.abs(card_server.last_style_table
                             - cpu.last_style_table).max())
    by_uid = {r.uid: r for r in ref}
    frames_equal = all(r.frames == by_uid[r.uid].frames for r in got)
    mel_err = max(float(np.abs(r.mel - by_uid[r.uid].mel).max())
                  for r in got if r.frames == by_uid[r.uid].frames)
    print(f"  serve fp32 card vs fp32 CPU plain path, 8 requests in buckets "
          f"256 and 512 at batch 4: dispatch order equal: "
          f"{order == ref_order} {order}, frames equal: {frames_equal} "
          f"{[r.frames for r in got]}, mel max_abs_err {mel_err:.2e} (tol "
          f"{FP32_PATH_TOL:.0e}), style table max_abs_err {style_err:.2e} "
          f"(tol {STYLE_TOL:.0e}; CPU run {t_cpu:.1f} s)")
    if order != ref_order or not frames_equal:
        raise AssertionError("serve fp32 card vs CPU: dispatch order or "
                             "frames differ")
    if not (mel_err <= FP32_PATH_TOL and style_err <= STYLE_TOL):
        raise AssertionError(f"serve fp32 card vs CPU: mel {mel_err}, style "
                             f"table {style_err}")


def phase_serve(card: str, light: bool = False) -> dict:
    """Level 5 at full size: (a) 256 requests, a warm-up call and the
    median of 5; (b) the contract's 4096 requests, once; (c) 256 requests
    with the vocoder, once; then the fp32 card-vs-CPU check.  ``light``
    runs (a) alone (``--paths-against``)."""
    cfg = serve_config()
    a = cfg.model.audio
    params = init_params(cfg, seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    server = Server(cfg, params, device="cuda")
    reqs = serve_requests(cfg, 256)
    server.serve_batch(reqs)                          # warm-up
    res = {"serve": drive_serve(server, reqs, n_calls=5,
                                label="serve 256 (mel)", card=card)}
    if light:
        del res["serve"]["results"]
        res["server"], res["reqs"] = server, reqs
        return res
    big = serve_requests(cfg, cfg.serve.max_global_batch)
    res["serve_4096"] = drive_serve(server, big, n_calls=1,
                                    label="serve 4096 (mel)", card=card)
    del big
    voc = Server(serve_config(with_vocoder=True), params, device="cuda")
    r = drive_serve(voc, reqs, n_calls=1,
                    label="serve 256 with the vocoder (first call)",
                    card=card)
    n_up = int(np.prod(cfg.model.vocoder.upsample_rates))
    est = {q.uid: q.est_frames for q in reqs}
    bad = []
    for x in r["results"]:
        bucket = bucketing.bucket_for(est[x.uid], cfg.serve.frame_buckets)
        n_wav = min(x.frames * a.hop_length,
                    (bucket * n_up - 1) * cfg.model.vocoder.istft_hop)
        if x.wav is None or x.wav.shape != (n_wav,) or \
                not np.isfinite(x.wav).all():
            bad.append(x.uid)
    print(f"    every waveform finite and frames x {a.hop_length} samples "
          f"long (cut to the vocoder's (bucket x {n_up} - 1) x "
          f"{cfg.model.vocoder.istft_hop} where a request fills its bucket): "
          f"{not bad}")
    if bad:
        raise AssertionError(f"serve with the vocoder: uids {bad[:10]}")
    res["serve_vocoder"] = r
    for r in res.values():
        del r["results"]                  # 4096 requests' mels: ~1 GB
    check_serve_parity(card, params)
    res["server"], res["reqs"] = server, reqs
    return res


def verify_expected_counts(cfg: Config, n_frames: int) -> dict:
    """Kernel launches of one run of the gate's program: the synthesis
    path's with the vocoder, without the prompt encoder and the denoiser
    (the style and the durations are given)."""
    m = cfg.model
    expect = expected_counts(cfg, n_frames)
    expect["full_attention"] -= (m.prompt_encoder.n_layers + 1
                                 + 2 * m.diffusion.n_layers)
    return expect


def phase_verify(card: str) -> dict:
    """Level 1 at full size: ``run_verification(max_frames=256, batch=1,
    device="cuda")``, whose default weights set the duration head's bias so
    the 64 phonemes fill most of the 256 frames; its report, no plain version on the card,
    the launches of its two card runs, and its gates."""
    cfg = Config(model=ModelConfig(max_text_len=64, max_frames=256),
                 runtime=RuntimeConfig(compute_dtype="float32"))
    reset_counts()
    rep = run_verification(max_frames=256, batch=1, device="cuda")
    counts = kernel_counts(torch.device("cuda"))
    check_no_plain_on_card("verify")
    check_counts("verify", counts, verify_expected_counts(cfg, 256), 2)
    print(f"  {json.dumps(rep)}")
    print(f"  kernel launches per card run (fp32 and bf16): "
          f"{ {k: n / 2 for k, n in counts.items() if n} }; no plain "
          f"version on the card  [{card}]")
    if not (rep["pass_fp32"] and rep["pass_bf16"]
            and rep["fp32_kernels"]["dur_match"] == 1.0):
        raise AssertionError(f"verify: gate failed {rep}")
    return {"counts": counts, "n_calls": 2}


# ---------------------------------------------------------------------------
# phase 19: acceptance levels and the synth, accept and bench commands
# ---------------------------------------------------------------------------

# The report keys of JAX's acceptance levels 2-5
# (``styletts_zs_tpu/pipelines/acceptance.py``) and of the port's level 1
# (``pipelines/verify.py``: JAX's keys with the variants under the port's
# names, and the golden's frames), and of ``bench.py``'s line, each with
# "device"; tests/test_torch_acceptance.py and tests/test_torch_cli.py hold
# them against JAX's.
_SYNTH_KEYS = frozenset({
    "config", "batch", "n_frames", "one_step", "with_vocoder",
    "wall_s_per_call", "wall_s_per_call_spread", "audio_s_per_s",
    "rtf_target_10x", "mel_finite", "device"})
ACCEPT_KEYS = {
    1: frozenset({"config", "backend", "device", "n_frames", "batch",
                  "golden_frames", "fp32_kernels", "bf16_kernels",
                  "bf16_plain", "pass_fp32", "pass_bf16"}),
    2: _SYNTH_KEYS, 3: _SYNTH_KEYS, 4: _SYNTH_KEYS | {"wav_finite"},
    5: frozenset({"config", "n_requests", "completed", "requeued", "mesh",
                  "bundle", "plan_batches", "served_batches",
                  "plan_matches_served", "style_table_shape", "wall_s",
                  "audio_s_per_s_incl_compile", "device"})}
BENCH_KEYS = frozenset({"metric", "value", "unit", "vs_baseline",
                        "rtf_batch1", "mel_mae_vs_fp32_golden", "device"})
SYNTH_TEXT = "the quick brown fox jumps over the lazy dog"


def _numbers(x):
    """Every number in a JSON value (booleans are not numbers here)."""
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def check_accept_report(level: int, rep: dict) -> None:
    """Fail unless level ``level``'s report has its keys, only finite
    numbers, and passes: level 1's gates, finite outputs for levels 2-4,
    level 5 with every request served as planned and none requeued."""
    if set(rep) != ACCEPT_KEYS[level]:
        raise AssertionError(f"level {level} report keys {sorted(rep)}, "
                             f"expected {sorted(ACCEPT_KEYS[level])}")
    if not np.isfinite(list(_numbers(rep))).all():
        raise AssertionError(f"level {level}: a number is not finite {rep}")
    if level == 1:
        ok = rep["pass_fp32"] and rep["pass_bf16"]
    elif level == 5:
        ok = (rep["plan_matches_served"] is True and rep["requeued"] == 0
              and rep["completed"] == rep["n_requests"])
    else:
        ok = rep["mel_finite"] and rep.get("wav_finite", True) and \
            rep["wall_s_per_call"] > 0
    if not ok:
        raise AssertionError(f"level {level} failed: {rep}")


def check_bench_line(rec: dict) -> None:
    """Fail unless ``bench``'s line has its keys, a positive finite
    throughput and RTF, and a finite MAE (0 where no frame was emitted)."""
    if set(rec) != BENCH_KEYS or \
            rec["metric"] != "audio_s_per_s_per_chip_batch32_1step":
        raise AssertionError(f"bench line {rec}")
    for k in ("value", "vs_baseline", "rtf_batch1"):
        if not (np.isfinite(rec[k]) and rec[k] > 0):
            raise AssertionError(f"bench {k} = {rec[k]}")
    if not (np.isfinite(rec["mel_mae_vs_fp32_golden"])
            and rec["mel_mae_vs_fp32_golden"] >= 0):
        raise AssertionError(f"bench mel MAE {rec['mel_mae_vs_fp32_golden']}")


def cli_stdout(argv: list[str]) -> str:
    """``python -m styletts_zs_torch.cli *argv`` in this process: what it
    printed."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_acceptance(card: str) -> dict:
    """(a) Level 2 at full size on the card (batch 8 x 1024 frames, 1-step,
    mel only, bf16) through ``run_acceptance``: its launches per call
    exactly as ``expected_counts`` says, ms per call, audio-s/s and peak
    memory; (b) ``accept --level 0``: all five levels' reports; (c) ``synth
    --ref`` a 1 s 16 kHz tone, ``--wav-out``: the mel and the 16-bit wav
    (under ``chiprun_out/``), with the launches of one synthesis call; (d)
    ``bench``: its line.  No plain version on the card after each."""
    cuda = torch.device("cuda")
    cfg = base_config(full=True)
    expect = expected_counts(cfg, cfg.model.max_frames, one_step=True,
                             with_vocoder=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rep = run_acceptance(2, device="cuda")
    counts = kernel_counts(cuda)
    check_no_plain_on_card("acceptance level 2")
    n_calls = 1 + acceptance.N_TIMED
    check_counts("level-2", counts, expect, n_calls)
    check_accept_report(2, rep)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lo, hi = rep["wall_s_per_call_spread"]
    print(f"  level 2 (batch {rep['batch']} x {rep['n_frames']} frames, "
          f"1-step, mel only, bf16): {rep['wall_s_per_call'] * 1e3:.2f} "
          f"ms/call (median of {acceptance.N_TIMED}, min {lo * 1e3:.2f}, max "
          f"{hi * 1e3:.2f}), {rep['audio_s_per_s']:.1f} audio-s/s, peak "
          f"memory {peak_gb:.2f} GB, kernel launches per call "
          f"{ {k: n // n_calls for k, n in counts.items() if n} } "
          f"(expected {expect}), no plain version on the card  [{card}]")
    if rep["device"] != card:
        raise AssertionError(f"level 2 device {rep['device']!r} vs {card!r}")
    res = {"counts": counts, "n_calls": n_calls}

    reset_counts()
    t0 = time.perf_counter()
    report = json.loads(cli_stdout(["accept", "--level", "0"]))
    check_no_plain_on_card("accept --level 0")
    if sorted(report) != [f"level_{lv}" for lv in range(1, 6)]:
        raise AssertionError(f"accept --level 0: {sorted(report)}")
    for lv in range(1, 6):
        check_accept_report(lv, report[f"level_{lv}"])
    l1, l5 = report["level_1"], report["level_5"]
    synth = "; ".join(
        f"level {lv} {r['wall_s_per_call'] * 1e3:.2f} ms/call, "
        f"{r['audio_s_per_s']:.1f} audio-s/s"
        for lv, r in ((lv, report[f"level_{lv}"]) for lv in (2, 3, 4)))
    print(f"  accept --level 0 ({time.perf_counter() - t0:.1f} s): level 1 "
          f"fp32 mel MAE {l1['fp32_kernels']['mel_mae']:.2e}, bf16 "
          f"{l1['bf16_kernels']['mel_mae']:.5f}; {synth}; level 5 "
          f"{l5['n_requests']} requests in {l5['wall_s']:.3f} s, plan {l5['plan_batches']} = served, requeued 0; no plain "
          f"version on the card  [{card}]")

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    sr_ref = 16000
    t = np.arange(sr_ref) / sr_ref
    write_wav(str(out / "ref_tone_16k.wav"), 0.5 * np.sin(2 * np.pi * 220 * t),
              sr_ref)
    syn_cfg = Config()
    reset_counts()
    cli_stdout(["synth", "--text", SYNTH_TEXT, "--ref",
                str(out / "ref_tone_16k.wav"), "--out", str(out / "synth.npy"),
                "--wav-out", str(out / "synth.wav")])
    counts = kernel_counts(cuda)
    check_no_plain_on_card("synth --ref")
    check_counts("synth", counts, expected_counts(
        syn_cfg, syn_cfg.model.max_frames), 1)
    mel = np.load(out / "synth.npy")
    wav, sr = read_wav(str(out / "synth.wav"))
    m = syn_cfg.model
    n_samples = ((m.max_frames * int(np.prod(m.vocoder.upsample_rates)) - 1)
                 * m.vocoder.istft_hop)
    if mel.shape != (m.max_frames, m.audio.n_mels) or \
            not np.isfinite(mel).all() or sr != m.audio.sample_rate or \
            wav.shape != (n_samples,):
        raise AssertionError(f"synth: mel {mel.shape}, wav {wav.shape} at "
                             f"{sr} Hz")
    print(f"  synth --ref (1 s at 16 kHz): mel {mel.shape} finite, "
          f"{wav.shape[0]} samples of 16-bit audio at {sr} Hz (peak "
          f"{np.abs(wav).max():.3f}), launches {counts}; no plain version "
          f"on the card")

    reset_counts()
    t0 = time.perf_counter()
    lines = cli_stdout(["bench"]).strip().splitlines()
    check_no_plain_on_card("bench")
    if len(lines) != 1:
        raise AssertionError(f"bench printed {lines}")
    rec = json.loads(lines[0])
    check_bench_line(rec)
    print(f"  bench ({time.perf_counter() - t0:.1f} s): {lines[0]}")
    if rec["device"] != card:
        raise AssertionError(f"bench device {rec['device']!r} vs {card!r}")
    return res


# ---------------------------------------------------------------------------
# the pipeline: the three stages with their gates, the bundle, level 5 on it
# ---------------------------------------------------------------------------

PIPELINE_STEPS = 2
PIPELINE_FRAMES = 256          # train_pipeline.py's full-config clips
REPORT_KEYS = ("config", "held_out_batch", "steps", "stage1_curve", "stage1",
               "stage1_gt_margin", "fsq_usage", "stage1_wall_s",
               "stage2_curve", "stage2", "stage2_wall_s", "stage3_curve",
               "stage3", "stage3_wall_s", "final")
# the kernels the decoder takes only above one chunk of frames: at 256
# frames it runs through full attention (row 2), forward and backward
PIPELINE_ZERO = ("local_attention", "local_attention_fwd_lse",
                 "local_attention_bwd_dq", "local_attention_bwd_dkv", "istft")


class CallProbe:
    """Wraps functions the pipeline calls: each call timed to its end (the
    card synchronised) with the kernel launches and twin backwards it made;
    launches between the wrapped calls are kept apart (``outside``)."""

    def __init__(self):
        self.events: list[dict] = []
        self.outside: dict[str, int] = {}
        self._last = ({}, {})
        self._undo: list = []

    def _delta(self):
        counts = kernel_counts(torch.device("cuda"))
        twins = dict(plain.twin_vjp_calls)
        lc, lt = self._last
        self._last = (counts, twins)
        return ({k: v - lc.get(k, 0) for k, v in counts.items()},
                {k: v - lt.get(k, 0) for k, v in twins.items()})

    def wrap(self, owner, attr: str, kind: str) -> None:
        fn = getattr(owner, attr)

        def timed(*a, **k):
            torch.cuda.synchronize()
            for name, n in self._delta()[0].items():
                self.outside[name] = self.outside.get(name, 0) + n
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts, twins = self._delta()
            self.events.append({"kind": kind, "name": attr, "ms": ms,
                                "counts": counts, "twins": twins})
            return out
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


PIPELINE_GATES = ("evaluate_acoustic", "speaker_similarity_margin",
                  "fsq_usage_stats", "evaluate_diffusion",
                  "evaluate_distill_gap", "speaker_similarity")


def probe_pipeline() -> CallProbe:
    probe = CallProbe()
    for n, cls in enumerate((Stage1Trainer, Stage2Trainer, Stage3Trainer)):
        probe.wrap(cls, "train_step", f"stage{n + 1} step")
    for name in PIPELINE_GATES:
        probe.wrap(eval_lib, name, "gate")
    probe.wrap(pipeline_lib.Synthesizer, "synthesize", "synthesis")
    return probe


def check_pipeline_steps(cfg: Config, probe: CallProbe) -> None:
    """Every train step launched what its stage's step launches at
    ``PIPELINE_FRAMES`` frames (the stage phases' predictions), with the
    twin backwards they predict."""
    n_teacher = cfg.model.diffusion.n_steps
    expect = {"stage1 step": train_expected_counts(cfg, PIPELINE_FRAMES),
              "stage2 step": stage2_expected_counts(cfg),
              "stage3 step": stage3_expected_counts(cfg, PIPELINE_FRAMES,
                                                    n_teacher)}
    for e in probe.events:
        if e["kind"] not in expect:
            continue
        want = expect[e["kind"]]
        got = {k: v for k, v in e["counts"].items() if v}
        if got != {k: v for k, v in want["kernels"].items() if v} or \
                {k: v for k, v in e["twins"].items() if v} != \
                {k: v for k, v in want["twins"].items() if v}:
            raise AssertionError(f"pipeline {e['kind']}: launches {got}, "
                                 f"twins {e['twins']}; expected {want}")


def report_pipeline(probe: CallProbe, card: str) -> None:
    """Each stage's step times, each gate's and synthesis's time, and the
    launches by kind of call."""
    by_kind: dict[str, list] = {}
    for e in probe.events:
        by_kind.setdefault(e["kind"], []).append(e)
    for kind, evs in by_kind.items():
        launches: dict[str, int] = {}
        for e in evs:
            for k, v in e["counts"].items():
                launches[k] = launches.get(k, 0) + v
        if kind == "gate" or kind == "synthesis":
            times = ", ".join(f"{e['name']} {e['ms']:.1f}" for e in evs)
        else:
            times = ", ".join(f"{e['ms']:.1f}" for e in evs)
        print(f"  pipeline {kind} ms: {times}; launches "
              f"{ {k: v for k, v in launches.items() if v} }  [{card}]")


def phase_pipeline(card: str) -> dict:
    """``run_pipeline`` on the card at full width (``Config()``, 147.6 M
    parameters, bf16 compute on fp32 masters; batch 16 x 256 frames, the
    script's full-config clips): ``PIPELINE_STEPS`` steps a stage, a gate
    every step; the report's keys, finite numbers, each step's launches as
    its stage predicts, no launch outside the probed calls, rows 1, 3-5
    and 11 at 0 (the decoder's 256 frames take row 2).  Then a second call
    that skips stages 1-2 (their saved trees, stage 3 starting from them,
    bit for bit) and runs one stage-3 step; then level 5 from the bundle
    the card trained."""
    work = Path(tempfile.mkdtemp(prefix="pipeline_"))
    probe = probe_pipeline()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with redirect_stdout(io.StringIO()) as out:
            report = pipeline_lib.run_pipeline(
                steps1=PIPELINE_STEPS, steps2=PIPELINE_STEPS,
                steps3=PIPELINE_STEPS, gate_every=1, eval_every=1,
                workdir=str(work), device="cuda")
    finally:
        probe.restore()
    wall = time.perf_counter() - t0
    counts = kernel_counts(torch.device("cuda"))
    check_no_plain_on_card("pipeline")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lines = out.getvalue().splitlines()
    for ln in lines:
        if ln.startswith('{"quality_gate"') or ln.startswith('{"stage"') \
                or "done in" in ln:
            print(f"    {ln[:400]}")
    cfg = Config()
    if tuple(report) != REPORT_KEYS or \
            not np.isfinite(list(_numbers(report))).all():
        raise AssertionError(f"pipeline report: keys {list(report)} or a "
                             f"number not finite")
    if report["steps"] != [PIPELINE_STEPS] * 3 or \
            len(report["stage1_curve"]) != PIPELINE_STEPS:
        raise AssertionError(f"pipeline report: steps {report['steps']}, "
                             f"stage-1 curve {report['stage1_curve']}")
    check_pipeline_steps(cfg, probe)
    if any(probe.outside.values()) or any(counts[k] for k in PIPELINE_ZERO):
        raise AssertionError(f"pipeline: launches outside the probed calls "
                             f"{probe.outside}, or rows 1/3-5/11 launched "
                             f"{counts}")
    summed = {}
    for e in probe.events:
        for k, v in e["counts"].items():
            summed[k] = summed.get(k, 0) + v
    if summed != counts:
        raise AssertionError(f"pipeline: {summed} over the calls, {counts} "
                             f"in all")
    print(f"  run_pipeline at full width ({cfg.train.batch_size} x "
          f"{PIPELINE_FRAMES} frames, bf16, {PIPELINE_STEPS} steps a stage, "
          f"a gate every step): {wall:.1f} s, stage walls "
          f"{[report[f'stage{i}_wall_s'] for i in (1, 2, 3)]} s, peak memory "
          f"{peak_gb:.2f} GB; launches "
          f"{ {k: v for k, v in counts.items() if v} } (rows 1, 3-5, 11 at "
          f"0 as predicted); no plain version on the card  [{card}]")
    report_pipeline(probe, card)
    print(f"    final: {report['final']}")

    # the second call: stages 1 and 2 from their saved trees
    seen = {}
    orig_init, orig_state = Stage3Trainer.__init__, Stage3Trainer.init_state

    def init(self, c, params, **k):
        seen["given"] = {p: {n: v.detach().cpu().clone()
                             for n, v in params[p].items()}
                         for p in ("acoustic", "diffusion")}
        orig_init(self, c, params, **k)

    def init_state(self, teacher):
        st = orig_state(self, teacher)
        seen["student"] = {n: v.cpu() for n, v in st.params.items()}
        return st
    Stage3Trainer.__init__, Stage3Trainer.init_state = init, init_state
    t0 = time.perf_counter()
    try:
        with redirect_stdout(io.StringIO()):
            rep2 = pipeline_lib.run_pipeline(
                steps1=PIPELINE_STEPS, steps2=PIPELINE_STEPS, steps3=1,
                workdir=str(work), skip_stage1=str(work / "stage1"),
                skip_stage2=str(work / "stage2"), device="cuda")
    finally:
        Stage3Trainer.__init__, Stage3Trainer.init_state = \
            orig_init, orig_state
    wall2 = time.perf_counter() - t0
    saved1 = load_params(str(work / "stage1"))["acoustic"]
    saved2 = load_params(str(work / "stage2"))
    same = (all(torch.equal(seen["given"]["acoustic"][k], v)
                for k, v in saved1.items())
            and all(torch.equal(seen["given"]["diffusion"][k], v)
                    for k, v in saved2.items())
            and all(torch.equal(seen["student"][k], v)
                    for k, v in saved2.items()))
    print(f"  run_pipeline --skip-stage1/2 --steps3 1: {wall2:.1f} s; stage "
          f"3 given the saved stage-1 acoustic and stage-2 teacher bit for "
          f"bit, the student starting as the teacher: {same}; stage-1 "
          f"curve extended to {len(rep2['stage1_curve'])} gates")
    if not same or len(rep2["stage1_curve"]) != PIPELINE_STEPS + 1:
        raise AssertionError("pipeline --skip-stage1/2: the trees stage 3 "
                             "got differ from the saved ones")
    t0 = time.perf_counter()
    rep5 = run_acceptance(5, bundle=str(work / "final"), device="cuda")
    check_no_plain_on_card("level 5 from the pipeline's bundle")
    check_accept_report(5, rep5)
    print(f"  run_acceptance(5, bundle=<the card's bundle>): "
          f"{time.perf_counter() - t0:.1f} s, {rep5['completed']} of "
          f"{rep5['n_requests']} requests, plan_batches "
          f"{rep5['plan_batches']}, requeued {rep5['requeued']}  [{card}]")
    shutil.rmtree(work, ignore_errors=True)
    return {"counts": counts, "n_calls": 1}


# ---------------------------------------------------------------------------
# the mesh: data-parallel serving and the stage-1 step, at world size 1 over
# NCCL, then two processes on the one card over gloo
# ---------------------------------------------------------------------------

MESH_SERVE_TOL = 1e-4          # fp32 mel, one process vs two ranks
MESH_TIMEOUT = 600             # seconds for the two-process group


def _time_collective(fn, n: int = 5) -> float:
    """Median ms of ``n`` calls, each to its end on the card."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def collective_times(mesh, grads: dict, table, mel) -> dict:
    """ms per call of the collectives the paths run, at their payloads:
    ``gather_style_codes`` of a style table's rows, ``gather_rows`` of a
    batch's mel rows, ``pmean_grads`` of a stage-1 gradient tree."""
    n = mesh_lib.batch_sharding(mesh).count
    take = mesh_lib.batch_sharding(mesh).take
    pad = -table.shape[0] % n
    table = torch.cat([table, table.new_zeros((pad, *table.shape[1:]))])
    before = dict(collectives.calls)
    res = {"gather_style_codes": _time_collective(
               lambda: collectives.gather_style_codes(mesh, take(table))),
           "gather_rows (mel)": _time_collective(
               lambda: collectives.gather_rows(mesh, take(mel))),
           "pmean_grads": _time_collective(
               lambda: collectives.pmean_grads(grads, mesh), n=3)}
    collectives.calls.clear()
    collectives.calls.update(before)
    return res


def _mesh_serve(params, mesh, n_requests: int, dtype: str):
    cfg = serve_config(dtype=dtype)
    reqs = serve_requests(cfg, n_requests)
    return Server(cfg, params, device="cuda", mesh=mesh), reqs


def serve_params() -> dict:
    params = init_params(serve_config(), seed=0, device="cpu")
    params["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    return params


def check_no_plain_on_ranks(mesh, label: str) -> None:
    """``check_no_plain_on_card`` on every rank of ``mesh`` together: the
    ranks (of both axes) first sum their plain-version counts, so that
    every rank fails when one does and none waits in a collective for a
    rank that stopped."""
    n = torch.tensor([float(sum(plain.cuda_calls.values()))], device="cuda")
    torch.distributed.all_reduce(n)
    if n.item():
        check_no_plain_on_card(label)
        raise AssertionError(f"{label}: plain versions ran on the card on "
                             f"another rank")


def mesh_worker(rank: int) -> dict:
    """One of two ranks on the one card over gloo: fp32 serving of 32
    requests at batch 32 (16 a rank), then the stage-1 step at the fp32
    parity batch (one utterance a rank), each followed by the plain
    versions' check on both ranks, the collectives timed."""
    mesh = mesh_lib.make_mesh()
    reset_counts()
    params = serve_params()
    server, reqs = _mesh_serve(params, mesh, 32, "float32")
    t0 = time.perf_counter()
    res = server.serve_batch(reqs)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    check_no_plain_on_ranks(mesh, f"fp32 serve on rank {rank}")
    cfg = train_config()
    cfg32 = dataclasses.replace(_no_dropout(cfg), runtime=RuntimeConfig(
        compute_dtype="float32"))
    tparams = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    tparams["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    nb = train_batch(cfg, 2, PARITY_SEED)
    t0 = time.perf_counter()
    got = train_parity_run(cfg32, tparams, nb, "cuda", mesh=mesh)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    check_no_plain_on_ranks(mesh, f"fp32 stage-1 step on rank {rank}")
    grads = {k: v.cuda() for k, v in got["grads"].items()}
    mel = torch.zeros(32, 1024, cfg.model.audio.n_mels, device="cuda")
    times = collective_times(mesh, grads, torch.from_numpy(
        server.last_style_table), mel)
    return {"serve": {r.uid: (r.frames, r.mel) for r in res},
            "order": [r.uid for r in res],
            "requeued": len(server.requeued), "train": got,
            "plain": dict(plain.cuda_calls),
            "ms": {"serve_batch": t_serve * 1e3,
                   "stage-1 losses and gradients": t_train * 1e3},
            "collectives": times, "calls": dict(collectives.calls)}


def run_ranks(job: str, n: int, timeout: int = MESH_TIMEOUT) -> list[dict]:
    """``chip_smoke.py --rank-job job --rank r`` for r < n on this card,
    each rank's output kept in ``chiprun_out/<job>_rank<r>.log``; all
    killed past ``timeout`` seconds.  Returns the ranks' results (each
    writes ``<out>/rank<r>.pt``)."""
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    result = Path(tempfile.mkdtemp(prefix=f"{job}_"))
    port = mesh_lib.free_port()
    procs, logs = [], []
    for r in range(n):
        log = open(out_dir / f"{job}_rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--rank-job", job,
             "--rank", str(r), "--world", str(n), "--port", str(port),
             "--out", str(result)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {n} {job} ranks did not finish in "
                             f"{timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        bad = next(r for r, p in enumerate(procs) if p.returncode)
        tail = (out_dir / f"{job}_rank{bad}.log").read_text()[-3000:]
        raise AssertionError(f"a {job} rank failed (chiprun_out/{job}_rank*"
                             f".log): {tail}")
    got = [torch.load(result / f"rank{r}.pt", weights_only=False)
           for r in range(n)]
    shutil.rmtree(result, ignore_errors=True)
    return got


def ranks_agree(a: dict, b: dict) -> bool:
    """Whether two ranks returned the same results bit for bit: the serve
    order, frames and mel per uid, the requeued count, and the stage-1
    losses, gradients, codes and durations."""
    ta, tb = a["train"], b["train"]
    return (a["order"] == b["order"] and a["requeued"] == b["requeued"]
            and a["serve"].keys() == b["serve"].keys()
            and all(a["serve"][u][0] == b["serve"][u][0]
                    and np.array_equal(a["serve"][u][1], b["serve"][u][1])
                    for u in a["serve"])
            and ta["losses"] == tb["losses"]
            and ta["grads"].keys() == tb["grads"].keys()
            and all(torch.equal(ta["grads"][k], tb["grads"][k])
                    for k in ta["grads"])
            and torch.equal(ta["indices"], tb["indices"])
            and torch.equal(ta["durations"], tb["durations"]))


def phase_mesh(card: str, serve_res: dict) -> dict:
    """(1) World size 1 over NCCL: ``Server(mesh=make_mesh())`` at level 5
    (256 requests, bf16) per uid equal to the serve phase's ``Server``;
    the stage-1 step with ``mesh=`` at the fp32 parity batch equal to the
    step without; each path's launches.  (2) Two processes on this card
    over gloo: fp32 serving of 32 requests (16 a rank) against one
    process, the stage-1 step with one utterance a rank against the
    one-process step.  The collectives' counts and ms per call."""
    mesh = mesh_lib.make_mesh()        # a group of this process, over NCCL
    print(f"  mesh {mesh_lib.mesh_shape(mesh)} over "
          f"{torch.distributed.get_backend()}  [{card}]")
    server, reqs = serve_res["server"], serve_res["reqs"]
    ref = {r.uid: r for r in server.serve_batch(reqs)}
    params = serve_params()
    mserver = Server(server.cfg, params, device="cuda", mesh=mesh)
    mserver.serve_batch(reqs)                          # warm-up
    collectives.calls.clear()
    r = drive_serve(mserver, reqs, n_calls=1, label="serve 256 on the mesh "
                    "(world size 1, NCCL)", card=card)
    calls = dict(collectives.calls)
    diff = max(float(np.abs(x.mel - ref[x.uid].mel).max())
               for x in r["results"])
    same = all(x.frames == ref[x.uid].frames for x in r["results"])
    print(f"    per uid against the Server without a mesh: frames equal "
          f"{same}, mel max_abs_err {diff:.2e}; collectives per call "
          f"{calls}")
    if not same or diff != 0.0:
        raise AssertionError(f"serve on the mesh: frames equal {same}, mel "
                             f"{diff}")
    serve_mesh = {"counts": r["counts"], "n_calls": 1}

    cfg = train_config()
    cfg32 = dataclasses.replace(_no_dropout(cfg), runtime=RuntimeConfig(
        compute_dtype="float32"))
    tparams = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    tparams["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    nb = train_batch(cfg, 2, PARITY_SEED)
    t0 = time.perf_counter()
    one = train_parity_run(cfg32, tparams, nb, "cuda")
    t_one = time.perf_counter() - t0
    reset_counts()
    dp = train_parity_run(cfg32, tparams, nb, "cuda", mesh=mesh)
    check_no_plain_on_card("fp32 stage-1 step on the mesh")
    if not (torch.equal(dp["indices"], one["indices"])
            and torch.equal(dp["durations"], one["durations"])):
        raise AssertionError("stage-1 step on the mesh: codes or durations "
                             "differ")
    gate_losses_and_grads(
        f"fp32 stage-1 step on the mesh (world size 1, NCCL) vs without, "
        f"batch 2 x {TRAIN_FRAMES}: codes and durations equal;", dp, one,
        t_one, card)
    # the path's launches: one data-parallel step at the stage-1 phase's
    # batch 16 x 1024, bf16, dropout on
    trainer = Stage1Trainer(cfg, tparams, device="cuda", mesh=mesh)
    batch = batch_to_device(train_batch(cfg, cfg.train.batch_size, 0),
                            "cuda", sharding=mesh_lib.batch_sharding(mesh))
    state, _ = trainer.train_step(trainer.init_state(tparams), batch)
    torch.cuda.synchronize()
    collectives.calls.clear()
    rt = drive_train(cfg, trainer, state, batch, device="cuda", n_steps=1,
                     label="stage-1 step on the mesh")
    print(f"  stage-1 step on the mesh (world size 1, NCCL, batch "
          f"{cfg.train.batch_size} x {TRAIN_FRAMES}, bf16): "
          f"{rt['seconds'] * 1e3:.1f} ms, launches as the stage-1 step's; "
          f"collectives per step {dict(collectives.calls)}  [{card}]")
    train_dp = {"counts": rt["counts"], "n_calls": 1}
    grads = {k: v.cuda() for k, v in dp["grads"].items()}
    times = collective_times(mesh, grads, torch.from_numpy(
        mserver.last_style_table), torch.zeros(
            32, 1024, cfg.model.audio.n_mels, device="cuda"))
    print(f"  collectives at world size 1 (NCCL), ms per call: "
          f"{ {k: round(v, 4) for k, v in times.items()} }  [{card}]")
    del trainer, state, batch, grads, mserver, rt
    torch.distributed.destroy_process_group()

    # two processes on the one card over gloo
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got, got1 = run_ranks("mesh", 2)
    t_workers = time.perf_counter() - t0
    same = ranks_agree(got, got1)
    print(f"  two ranks: rank 1's serve results, losses, gradients, codes "
          f"and durations equal to rank 0's: {same}; plain versions on "
          f"the card {got['plain']} / {got1['plain']}")
    if not same or got["plain"] or got1["plain"]:
        raise AssertionError("the two ranks disagree, or a plain version "
                             "ran on the card")
    cfg_s = serve_config(dtype="float32")
    res32 = Server(cfg_s, params, device="cuda").serve_batch(
        serve_requests(cfg_s, 32))
    ref32, order = {x.uid: x for x in res32}, [x.uid for x in res32]
    frames_eq = all(f == ref32[u].frames for u, (f, _) in got["serve"].items())
    err = max(float(np.abs(m - ref32[u].mel).max())
              for u, (f, m) in got["serve"].items()
              if f == ref32[u].frames)
    print(f"  two ranks on this card over gloo ({t_workers:.1f} s with "
          f"start-up): fp32 serve of 32 requests at batch 32 (16 a rank) "
          f"against one process: order equal {got['order'] == order}, "
          f"frames equal {frames_eq}, mel max_abs_err {err:.2e} (tol "
          f"{MESH_SERVE_TOL:.0e}), requeued {got['requeued']}; ms "
          f"{ {k: round(v, 1) for k, v in got['ms'].items()} }; "
          f"collectives ms per call "
          f"{ {k: round(v, 3) for k, v in got['collectives'].items()} }, "
          f"calls {got['calls']}  [{card}]")
    if got["order"] != order or not frames_eq or not err <= MESH_SERVE_TOL \
            or got["requeued"]:
        raise AssertionError("serve on two ranks differs from one process")
    dp2 = got["train"]
    if not (torch.equal(dp2["indices"], one["indices"])
            and torch.equal(dp2["durations"], one["durations"])):
        raise AssertionError("stage-1 step on two ranks: codes or durations "
                             "differ")
    gate_losses_and_grads(
        f"fp32 stage-1 step on two ranks (gloo, one utterance a rank) vs one "
        f"process, batch 2 x {TRAIN_FRAMES}: codes and durations equal;",
        dp2, one, t_one, card)
    return {"serve_mesh": serve_mesh, "train_stage1_dp": train_dp}


# ---------------------------------------------------------------------------
# tensor parallelism: the model axis
# ---------------------------------------------------------------------------

def tensor_collective_times(group, cfg: Config) -> dict:
    """ms per call of the model axis's collectives at the bf16 step's
    payloads over ``group``: the gather of a Dense's output chunks (16 x
    1024 x 256 bf16 a rank), the sum of an input gradient (copy_to_model's
    backward, 16 x 1024 x 512 bf16), the AdaIN block's sum of partial dh
    (fp32), and the clip's one-number sum."""
    B, T, C = cfg.train.batch_size, TRAIN_FRAMES, cfg.model.decoder.dim
    n = torch.distributed.get_world_size(group)
    y = torch.zeros(B, T, C // n, dtype=torch.bfloat16, device="cuda")
    dx = torch.zeros(B, T, C, dtype=torch.bfloat16, device="cuda")
    axis = tensor_lib.ModelAxis(group)
    one = torch.zeros(1, device="cuda")
    before = dict(tensor_lib.calls)
    res = {"gather_features": _time_collective(
               lambda: tensor_lib._gather(y, 2, group)),
           "copy_to_model backward": _time_collective(
               lambda: tensor_lib._sum(dx, group)),
           "sum_partials (fp32)": _time_collective(lambda: axis.sum(dx)),
           "clip norm": _time_collective(
               lambda: torch.distributed.all_reduce(one, group=group))}
    tensor_lib.calls.clear()
    tensor_lib.calls.update(before)
    return res


def tensor_worker(rank: int) -> dict:
    """One of two ranks, (data 1, model 2), on the one card over gloo, at
    full width: the stage-1 step's fp32 losses and whole gradients at the
    parity batch, then the bf16 step at batch 16 x 1024 (dropout on) with
    its ms, launches, the bytes this rank holds, peak memory and the
    model-axis collectives' calls and ms; the plain versions' check on
    both ranks after each."""
    mesh = mesh_lib.make_mesh(1, 2)
    cfg = train_config()
    cfg32 = dataclasses.replace(_no_dropout(cfg), runtime=RuntimeConfig(
        compute_dtype="float32"))
    tparams = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    tparams["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    reset_counts()
    t0 = time.perf_counter()
    got = train_parity_run(cfg32, tparams, train_batch(cfg, 2, PARITY_SEED),
                           "cuda", mesh=mesh)
    torch.cuda.synchronize()
    t_parity = time.perf_counter() - t0
    check_no_plain_on_ranks(mesh, f"fp32 tensor-parallel step on rank {rank}")
    trainer = Stage1Trainer(cfg, tparams, device="cuda", mesh=mesh)
    state = trainer.init_state(tparams)
    local_bytes = sharding_lib.estimate_bytes(state.g_params)
    whole_bytes = sharding_lib.estimate_bytes(
        {p: tparams[p] for p in G_PARTS})
    batch = batch_to_device(train_batch(cfg, cfg.train.batch_size, 0),
                            "cuda", sharding=mesh_lib.batch_sharding(mesh))
    state, _ = trainer.train_step(state, batch)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tensor_lib.calls.clear()
    rt = drive_train(cfg, trainer, state, batch, device="cuda", n_steps=1,
                     label=f"tensor-parallel stage-1 step on rank {rank}")
    calls = dict(tensor_lib.calls)
    peak = torch.cuda.max_memory_allocated()
    check_no_plain_on_ranks(mesh, f"bf16 tensor-parallel step on rank {rank}")
    times = tensor_collective_times(trainer.model_group, cfg)
    return {"train": got, "plain": dict(plain.cuda_calls),
            "parity_s": t_parity, "step_ms": rt["seconds"] * 1e3,
            "counts": rt["counts"], "twins": rt["twins"],
            "losses": rt["losses"], "local_bytes": local_bytes,
            "whole_bytes": whole_bytes, "peak_bytes": peak, "calls": calls,
            "collectives_ms": times}


def dryrun_worker(rank: int) -> dict:
    """One of four ranks running ``graft_entry.dryrun_multichip(4)`` on the
    one card over gloo: its printed line, and the plain versions."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        graft_entry.dryrun_multichip(torch.distributed.get_world_size())
    return {"line": buf.getvalue().strip(), "plain": dict(plain.cuda_calls)}


RANK_JOBS = {"mesh": mesh_worker, "tensor": tensor_worker,
             "dryrun": dryrun_worker}


def rank_worker(job: str, rank: int, world: int, port: int,
                out: Path) -> None:
    """One rank of ``job``'s group on this card over gloo (NCCL refuses two
    ranks a card), TF32 off; writes its results to ``out/rank<r>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_lib.multihost_init(f"tcp://localhost:{port}", world, rank,
                            backend="gloo")
    torch.save(RANK_JOBS[job](rank), out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def tensor_ranks_differ(a: dict, b: dict) -> list[str]:
    """What two model ranks returned differently: the fp32 losses, whole
    gradients (by name), codes and durations bit for bit, the bf16 step's
    losses and launches; empty where they agree."""
    ta, tb = a["train"], b["train"]
    out = [f"fp32 loss {k}" for k in ta["losses"]
           if ta["losses"][k] != tb["losses"].get(k)]
    out += [f"gradient {k}" for k in ta["grads"]
            if k not in tb["grads"] or not torch.equal(ta["grads"][k],
                                                       tb["grads"][k])]
    out += [k for k in ("indices", "durations")
            if not torch.equal(ta[k], tb[k])]
    out += [f"bf16 {k}" for k in ("losses", "counts") if a[k] != b[k]]
    return out


def phase_tensor(card: str) -> dict:
    """(a) Two ranks of this script (data 1, model 2) on this card over
    gloo at full width: the stage-1 step's fp32 losses and whole gradients
    at the parity batch against the one-process step, rank 1 against rank
    0 bit for bit, then the bf16 step at 16 x 1024 (ms, launches as the
    one-process step's, the bytes a rank holds, peak memory, the model
    axis's collectives); no plain version on either rank.  (b)
    ``dryrun_multichip(4)`` as four gloo ranks on the card.  (c)
    ``graft_entry.entry()`` once, and ``scaling_bench --mesh 1`` at full
    width over NCCL at world size 1."""
    cfg = train_config()
    cfg32 = dataclasses.replace(_no_dropout(cfg), runtime=RuntimeConfig(
        compute_dtype="float32"))
    tparams = init_params(cfg, seed=0, device="cpu", with_discriminator=True)
    tparams["acoustic"]["duration_predictor.out.bias"].fill_(DURATION_BIAS)
    nb = train_batch(cfg, 2, PARITY_SEED)
    t0 = time.perf_counter()
    one = train_parity_run(cfg32, tparams, nb, "cuda")
    t_one = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got, got1 = run_ranks("tensor", 2)
    t_ranks = time.perf_counter() - t0
    differ = tensor_ranks_differ(got, got1)
    print(f"  two ranks (data 1, model 2) on this card over gloo "
          f"({t_ranks:.1f} s with start-up): rank 1's losses, whole "
          f"gradients, codes, durations, bf16 losses and launches equal to "
          f"rank 0's: {not differ} {differ[:20]}; plain versions on the "
          f"card {got['plain']} / {got1['plain']}")
    if differ or got["plain"] or got1["plain"]:
        raise AssertionError("the two model ranks disagree, or a plain "
                             "version ran on the card")
    tp = got["train"]
    if not (torch.equal(tp["indices"], one["indices"])
            and torch.equal(tp["durations"], one["durations"])):
        raise AssertionError("tensor-parallel stage-1 step: codes or "
                             "durations differ")
    gate_losses_and_grads(
        f"fp32 stage-1 step on (data 1, model 2), gradients gathered whole, "
        f"vs one process, batch 2 x {TRAIN_FRAMES}: codes and durations "
        f"equal;", tp, one, t_one, card)
    expect = train_expected_counts(cfg, TRAIN_FRAMES)
    print(f"  bf16 stage-1 step on (data 1, model 2), batch "
          f"{cfg.train.batch_size} x {TRAIN_FRAMES}, dropout on: "
          f"{got['step_ms']:.1f} / {got1['step_ms']:.1f} ms (rank 0 / 1, one "
          f"step after a warm-up); generator fp32 tree a rank "
          f"{got['local_bytes'] / 1e6:.1f} MB against "
          f"{got['whole_bytes'] / 1e6:.1f} MB in one process; peak memory "
          f"{got['peak_bytes'] / 1e9:.2f} / {got1['peak_bytes'] / 1e9:.2f} "
          f"GB; launches per rank per step {got['counts']} (one process: "
          f"{expect['kernels']}); twin backwards {got['twins']}  [{card}]")
    print(f"  model-axis collectives per step {got['calls']}; ms per call "
          f"over gloo "
          f"{ {k: round(v, 3) for k, v in got['collectives_ms'].items()} }; "
          f"the fp32 losses and gradients {got['parity_s']:.1f} s  [{card}]")

    t0 = time.perf_counter()
    dry = run_ranks("dryrun", 4)
    line = dry[0]["line"]
    print(f"  dryrun_multichip(4) on four gloo ranks of this card "
          f"({time.perf_counter() - t0:.1f} s with start-up): {line}; plain "
          f"versions {[r['plain'] for r in dry]}")
    if not line.startswith("dryrun_multichip OK: mesh=(2,2)") or \
            any(r["plain"] for r in dry):
        raise AssertionError(f"dryrun_multichip(4): {line!r}")

    fn, args = graft_entry.entry()
    mel, wav = fn(*args)
    torch.cuda.synchronize()
    print(f"  graft_entry.entry(): mel {tuple(mel.shape)}, waveform "
          f"{tuple(wav.shape)}, finite "
          f"{bool(mel.isfinite().all() and wav.isfinite().all())}")
    if mel.shape != (2, 256, 80) or not (mel.isfinite().all()
                                         and wav.isfinite().all()):
        raise AssertionError("graft_entry.entry(): wrong shape or not finite")
    del fn, args, mel, wav

    buf = io.StringIO()
    with redirect_stdout(buf):
        scaling_bench.main(["--mesh", "1"])
    rows = [json.loads(x) for x in buf.getvalue().splitlines()]
    print(f"  scaling_bench --mesh 1 (full width, batch 8, NCCL at world "
          f"size 1): {rows}  [{card}]")
    if len(rows) != 1 or set(rows[0]) != {"n_devices", "audio_s_per_s",
                                          "efficiency_vs_linear"} or \
            not rows[0]["audio_s_per_s"] > 0:
        raise AssertionError(f"scaling_bench: {rows}")
    return {"train_stage1_tp": {"counts": got["counts"], "n_calls": 1}}


# ---------------------------------------------------------------------------
# --against: every row's kernels against a parent commit's
# ---------------------------------------------------------------------------

def _parent_library(parent: Path) -> build.KernelLibrary:
    """The kernel library of the tree unpacked at ``parent``, built by its
    own ``kernels/build.py`` into its own ``build/``."""
    spec = importlib.util.spec_from_file_location(
        "parent_kernel_build",
        parent / "styletts_zs_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.library()


def _launch_local(lib, q, k, v, lengths, chunk: int) -> torch.Tensor:
    """``local_attention_fwd`` of ``lib`` on bf16 CUDA q/k/v views."""
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    build.check(lib.local_attention_fwd(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, T, H, D, chunk,
        *[st for x in (q, k, v) for st in x.stride()[:3]], D ** -0.5,
        torch.cuda.current_stream().cuda_stream), "local_attention_fwd")
    return out


def _launch_full(lib, q, k, v, mask) -> torch.Tensor:
    """``full_attention_fwd`` of ``lib`` on fp32 or bf16 CUDA q/k/v views."""
    B, Tq, H, D = q.shape
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device)
    build.check(lib.full_attention_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, Tq, k.shape[1], H, D,
        *[st for x in (q, k, v) for st in x.stride()[:3]],
        0 if mask is None else mask.stride(0),
        D ** -0.5, torch.cuda.current_stream().cuda_stream),
        "full_attention_fwd")
    return out


def _launch_local_lse(lib, q, k, v, lengths, chunk: int):
    """``local_attention_fwd_lse`` of ``lib`` (row 3): (out, lse)."""
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    build.check(lib.local_attention_fwd_lse(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, H, D, chunk,
        *[st for x in (q, k, v) for st in x.stride()[:3]], D ** -0.5,
        torch.cuda.current_stream().cuda_stream), "local_attention_fwd_lse")
    return out, lse


def _bwd_args(q, k, v, g, lse, delta, lengths):
    """The pointers and strides the two backward entry points share."""
    B, T, H, D = q.shape
    return ([x.data_ptr() for x in (q, k, v, g, lse, delta, lengths)],
            [B, T, H, D], [st for x in (q, k, v, g) for st in x.stride()[:3]])


def _launch_bwd_dq(lib, q, k, v, g, lse, delta, lengths, chunk: int):
    """``local_attention_bwd_dq`` of ``lib`` (row 4) on bf16 CUDA tensors."""
    ptrs, shape, strides = _bwd_args(q, k, v, g, lse, delta, lengths)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    build.check(lib.local_attention_bwd_dq(
        1, *ptrs, dq.data_ptr(), *shape, chunk, *strides, q.shape[-1] ** -0.5,
        torch.cuda.current_stream().cuda_stream), "local_attention_bwd_dq")
    return dq


def _launch_bwd_dkv(lib, q, k, v, g, lse, delta, lengths, chunk: int):
    """``local_attention_bwd_dkv`` of ``lib`` (row 5): (dk, dv)."""
    ptrs, shape, strides = _bwd_args(q, k, v, g, lse, delta, lengths)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    build.check(lib.local_attention_bwd_dkv(
        1, *ptrs, dk.data_ptr(), dv.data_ptr(), *shape, chunk, *strides,
        q.shape[-1] ** -0.5, torch.cuda.current_stream().cuda_stream),
        "local_attention_bwd_dkv")
    return dk, dv


def _launch_convt(lib, x, w, stride: int = 5) -> torch.Tensor:
    """``conv_transpose_fwd`` of ``lib`` (row 10) on a bf16 CUDA x, with
    the vocoder's leaky ReLU."""
    B, T, C_in = x.shape
    K, _, C_out = w.shape
    out = torch.empty(B, C_out, T * stride, dtype=x.dtype, device=x.device)
    build.check(lib.conv_transpose_fwd(
        1, x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, C_in, C_out, K,
        stride, *x.stride(), 1, 0.1,
        torch.cuda.current_stream().cuda_stream), "conv_transpose_fwd")
    return out.transpose(1, 2)


def _launch_adain(lib, x, sc, sh, mean, rstd, w, dilation: int):
    """``adain_conv_fwd`` of ``lib`` (row 6) on bf16 CUDA tensors."""
    B, T, C = x.shape
    K, _, C_out = w.shape
    out = torch.empty(B, T, C_out, dtype=x.dtype, device=x.device)
    build.check(lib.adain_conv_fwd(
        1, x.data_ptr(), sc.data_ptr(), sh.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, C, C_out, K,
        dilation, *ac_kernel._bt_strides(x), *ac_kernel._bt_strides(sc),
        *ac_kernel._bt_strides(sh), torch.cuda.current_stream().cuda_stream),
        "adain_conv_fwd")
    return out


def _launch_adain_bwd(lib, dc, x, sc, sh, mean, rstd, w, dilation: int):
    """``adain_conv_bwd_data`` of ``lib`` (row 7) on bf16 CUDA tensors."""
    B, T, C = x.shape
    K, _, C_out = w.shape
    out = torch.empty(B, T, C, dtype=x.dtype, device=x.device)
    build.check(lib.adain_conv_bwd_data(
        1, dc.data_ptr(), x.data_ptr(), sc.data_ptr(), sh.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), w.data_ptr(), out.data_ptr(), B, T,
        C, C_out, K, dilation, *ac_kernel._bt_strides(x),
        *ac_kernel._bt_strides(sc), *ac_kernel._bt_strides(sh),
        torch.cuda.current_stream().cuda_stream), "adain_conv_bwd_data")
    return out


def _launch_euler(lib, x, dc, du, s_cur, s_next, guidance: float = 3.0):
    """``sampler_euler_fwd`` of ``lib`` (row 8) on fp32 CUDA tensors."""
    s_cur, _, ds, _ = sampler_kernel._sigmas(s_cur, s_next)
    x_out, d_out = torch.empty_like(x), torch.empty_like(x)
    build.check(lib.sampler_euler_fwd(
        x.data_ptr(), dc.data_ptr(), du.data_ptr(), x_out.data_ptr(),
        d_out.data_ptr(), x.numel(), float(s_cur), float(ds),
        float(np.float32(guidance)), torch.cuda.current_stream().cuda_stream),
        "sampler_euler_fwd")
    return x_out, d_out


def _launch_heun(lib, x, xe, dc, du, d1, s_cur, s_next,
                 guidance: float = 3.0):
    """``sampler_heun_fwd`` of ``lib`` (row 9) on fp32 CUDA tensors."""
    _, _, ds, s_div = sampler_kernel._sigmas(s_cur, s_next)
    out = torch.empty_like(x)
    build.check(lib.sampler_heun_fwd(
        x.data_ptr(), xe.data_ptr(), dc.data_ptr(), du.data_ptr(),
        d1.data_ptr(), out.data_ptr(), x.numel(), float(ds * np.float32(0.5)),
        float(s_div), float(np.float32(guidance)),
        torch.cuda.current_stream().cuda_stream), "sampler_heun_fwd")
    return out


def _launch_istft(lib, real, imag, n_fft: int = 48, hop: int = 12):
    """Row 11 of ``lib`` on contiguous fp32 CUDA spectra: ``istft_sm90_fwd``
    where the library has it, else ``istft_fwd`` (a tree before it)."""
    B, F, _ = real.shape
    out = torch.empty(B, (F - 1) * hop, dtype=torch.float32,
                      device=real.device)
    stream = torch.cuda.current_stream().cuda_stream
    sm90 = getattr(lib, "istft_sm90_fwd", None)
    if sm90 is not None:
        Fc = istft_kernel.envelope_table(n_fft, hop, F)[1]
        syn, table = istft_kernel.sm90_constants(n_fft, hop, Fc, real.device)
        grid = min(istft_kernel.sm90_grid(n_fft, real.device),
                   B * istft_kernel.sm90_slots(n_fft, hop, F)[1])
        build.check(sm90(real.data_ptr(), imag.data_ptr(), syn.data_ptr(),
                         table.data_ptr(), out.data_ptr(), B, F, n_fft, hop,
                         Fc, grid, stream), "istft_sm90_fwd")
        return out
    FT, syn_shared = istft_kernel.launch_geometry(n_fft, hop)
    syn, inv_env = head_kernel.ola_constants(n_fft, hop, F, real.device)
    build.check(lib.istft_fwd(
        real.data_ptr(), imag.data_ptr(), syn.data_ptr(), inv_env.data_ptr(),
        out.data_ptr(), B, F, n_fft, hop, FT, int(syn_shared), stream),
        "istft_fwd")
    return out


def _launch_head(lib, x, w, b, n_fft: int = 48, hop: int = 12):
    """``synthesis_head_fwd`` of ``lib`` (row 12) on a bf16 CUDA x, w and b,
    through that library's ABI: with x's strides and the tile walk (this
    tree), or with x contiguous (B, T, C), copied here (a tree before the
    strides, whose ``dispatch.synthesis_head`` made that copy)."""
    B, T, C = x.shape
    K = w.shape[0]
    syn, inv_env = head_kernel.ola_constants(n_fft, hop, T, x.device)
    out = torch.empty(B, (T - 1) * hop, dtype=torch.float32, device=x.device)
    fn = lib.synthesis_head_fwd
    if len(fn.argtypes) == 14:
        x = x.contiguous()
        extra = ()
    else:
        extra = (*x.stride(), *head_kernel.sm90_walk(
            B, T, torch.cuda.get_device_properties(0).multi_processor_count))
    build.check(fn(1, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                   syn.data_ptr(), inv_env.data_ptr(), out.data_ptr(), B, T,
                   C, K, n_fft, hop, *extra,
                   torch.cuda.current_stream().cuda_stream),
                "synthesis_head_fwd")
    return out


def _kernel_name(mangled: str) -> str:
    """The kernel's name and its template's policy from a mangled entry
    name (each identifier is prefixed by its length)."""
    names, i = [], 0
    while i < len(mangled):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i:
            i += 1
            continue
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    keep = [x for x in names if x.endswith(("_kernel", "Policy"))]
    return " ".join(keep) or mangled[:70]


def _print_resources(who: str, lib: build.KernelLibrary) -> None:
    """Registers, spills and static shared memory of the bf16 kernels of
    rows 1-7, 10 and 12, row 2's fp32 kernel and row 11's kernels from a
    library's ``-Xptxas -v`` log; blocks per SM of rows 2 (fp32, at Tk
    272), 4, 5, 6, 7, 12 and 11 (sm90) where the library reports them."""
    entry = ""
    for line in lib.log.splitlines():
        if "Compiling entry" in line:
            entry = _kernel_name(line.split()[-3].strip("'"))
        if any(k in entry for k in ("attn_fwd", "full_attn", "conv_transpose",
                                    "dq_tc", "dkv_tc", "dq_sm90", "dkv_sm90",
                                    "adain_conv_tc", "adain_conv_sm90",
                                    "adain_bwd_data", "synth_head",
                                    "istft")) and (
                "Used" in line or "spill" in line):
            print(f"    {who} {entry}: {line.strip()}")
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    for label, name, args in (("row 2 fp32", "full_attention_f32_occupancy",
                               (272,)),
                              ("row 4", "local_attention_bwd_occupancy", (0,)),
                              ("row 5", "local_attention_bwd_occupancy", (1,)),
                              ("row 6", "adain_conv_fwd_occupancy", ()),
                              ("row 7", "adain_conv_bwd_data_occupancy", ()),
                              ("row 12", "synthesis_head_fwd_occupancy", ()),
                              ("row 11 sm90 at n_fft 48",
                               "istft_sm90_occupancy", (48,))):
        occupancy = getattr(lib.lib, name, None)
        if occupancy is None:
            print(f"    {who}: {label} blocks per SM not reported by that "
                  f"library")
            continue
        occupancy.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p] * 2
        build.check(occupancy(*args, ctypes.byref(blocks),
                              ctypes.byref(smem)), name)
        print(f"    {who} {label}: {smem.value} bytes of dynamic "
              f"shared memory a block, {blocks.value} blocks per SM")


def phase_against_parent(parent: str, card: str) -> dict:
    """Rows 1-7, 10 and 12 in bf16 and rows 2 (the denoiser's), 8, 9 and 11
    in fp32 at every shape the paths launch them (row 6 with time-varying
    style at each dilation and with global style at d 1; row 12 on the
    vocoder's (B, C, T)-major view, which a parent without the strided
    entry point is given as a contiguous copy, timed with the copy): this
    tree's kernels against those of the tree unpacked at ``parent``, both
    held against the plain version, then timed in turns (parent, this,
    this, parent) on the same inputs."""
    old = _parent_library(Path(parent).resolve())
    new = build.library()
    print(f"  parent library {old.path} (built in {old.build_seconds:.1f} "
          f"s)  [{card}]")
    _print_resources("parent", old)
    _print_resources("this", new)
    g = torch.Generator(device="cuda").manual_seed(9)
    chunk = 256
    cases = []
    for T in (1024, 512):
        for masked in (True, False):
            q, k, v, lengths = _attention_inputs(torch.bfloat16, masked, g,
                                                 T=T)
            cases.append((f"row 1 B32 T{T} c{chunk} "
                          f"{'masked' if masked else 'unmasked'}",
                          _launch_local, (q, k, v, lengths, chunk),
                          la_kernel.local_attention_plain(
                              q, k, v, lengths, chunk=chunk)))
    for label, (B, Tq, Tk, kw) in {
            "text": (32, 256, 256, dict(self_attn=True)),
            "prompt": (32, 240, 240, dict(self_attn=True)),
            "pool": (32, 16, 240, {})}.items():
        q, k, v, mask = _full_attention_inputs(B, Tq, Tk, torch.bfloat16, g,
                                               **kw)
        cases.append((f"row 2 {label} B{B} Tq{Tq} Tk{Tk}", _launch_full,
                      (q, k, v, mask),
                      fa_kernel.full_attention_plain(q, k, v, mask)))
    for label, (B, Tq, Tk, kw) in {
            "den_cross": (64, 50, 272, dict(n_prompt=16)),
            "den_self": (64, 50, 50, dict(self_attn=True))}.items():
        q, k, v, mask = _full_attention_inputs(B, Tq, Tk, torch.float32, g,
                                               **kw)
        if label == "den_self":      # the path's self-attention: no mask
            mask = None
        cases.append((f"row 2 fp32 {label} B{B} Tq{Tq} Tk{Tk}", _launch_full,
                      (q, k, v, mask),
                      fa_kernel.full_attention_plain(q, k, v, mask),
                      torch.float32))
    q, k, v, lengths = _attention_inputs(torch.bfloat16, True, g, T=chunk)
    mask = length_mask(lengths, chunk)
    cases.append((f"row 2 serve bucket decoder B32 T{chunk} masked",
                  _launch_full, (q, k, v, mask),
                  fa_kernel.full_attention_plain(q, k, v, mask)))
    for T in (1024, 2 * chunk):
        q, k, v, _, lengths = _attention_train_inputs(16, T, torch.bfloat16,
                                                      g, chunk)
        cases.append((f"row 3 B16 T{T} c{chunk} masked", _launch_local_lse,
                      (q, k, v, lengths, chunk),
                      la_kernel.local_attention_fwd_lse_plain(
                          q, k, v, lengths, chunk=chunk)))
    for T in (1024, 2 * chunk):
        q, k, v, gout, lengths = _attention_train_inputs(16, T, torch.bfloat16,
                                                         g, chunk)
        out, lse = la_kernel.local_attention_fwd_lse_cuda(q, k, v, lengths,
                                                          chunk=chunk)
        delta = (gout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, gout, lse, delta, lengths)
        cases.append((f"row 4 B16 T{T} c{chunk} masked", _launch_bwd_dq,
                      (*args, chunk), la_kernel.local_attention_bwd_dq_plain(
                          *args, chunk=chunk)))
        cases.append((f"row 5 B16 T{T} c{chunk} masked", _launch_bwd_dkv,
                      (*args, chunk), la_kernel.local_attention_bwd_dkv_plain(
                          *args, chunk=chunk)))
    for label, (B, T) in _ADAIN_CASES.items():
        for tv in (True, False):
            args = _adain_inputs(B, T, torch.bfloat16, g, time_varying=tv)
            for d in ((1, 3, 9) if tv else (1,)):
                cases.append((f"row 6 {label} B{B} T{T} d{d}"
                              f"{'' if tv else ' global'}", _launch_adain,
                              (*args, d), ac_kernel.adain_conv_pass_plain(
                                  *args, dilation=d)))
    args = _adain_inputs(16, 1024, torch.bfloat16, g, time_varying=True)
    dc = torch.randn(16, 1024, 512, generator=g, device="cuda").to(
        torch.bfloat16)
    for d in (1, 3, 9):
        cases.append((f"row 7 train_b16 B16 T1024 d{d}", _launch_adain_bwd,
                      (dc, *args, d), ac_kernel.adain_conv_bwd_data_plain(
                          dc, *args, dilation=d)))
    sig = karras_sigmas(base_config(full=True).model.diffusion, 16)
    x = torch.randn(32, 50, 128, generator=g, device="cuda") * float(sig[0])
    den2 = torch.randn(64, 50, 128, generator=g, device="cuda")
    dc, du = den2[:32], den2[32:]
    cases.append(("row 8 multi_step B32 (50, 128) step 0", _launch_euler,
                  (x, dc, du, sig[0], sig[1]), sampler_kernel.euler_step_plain(
                      x, dc, du, sig[0], sig[1], guidance=3.0),
                  torch.float32))
    xe, d1 = (torch.randn(32, 50, 128, generator=g, device="cuda")
              for _ in range(2))
    cases.append(("row 9 multi_step B32 (50, 128) step 14", _launch_heun,
                  (x, xe, dc, du, d1, sig[14], sig[15]),
                  sampler_kernel.heun_correction_plain(
                      x, xe, dc, du, d1, sig[14], sig[15], guidance=3.0),
                  torch.float32))
    for B, F in ((32, 25600), (4, 121600)):
        real, imag = (torch.randn(B, F, 25, generator=g, device="cuda")
                      for _ in range(2))
        cases.append((f"row 11 B{B} F{F}", _launch_istft, (real, imag),
                      istft_kernel.istft_plain(real, imag, n_fft=48, hop=12),
                      torch.float32))
    for label, (B, T, C_in, C_out) in _CONVT_CASES.items():
        x, w = _convt_inputs(B, T, C_in, C_out, torch.bfloat16, g)
        cases.append((f"row 10 {label} ({B}, {T}, {C_in}) -> {C_out}",
                      _launch_convt, (x, w),
                      ct_kernel.conv_transpose1d_plain(x, w, stride=5,
                                                       negative_slope=0.1)))
    for label, (B, T) in _HEAD_CASES.items():
        x, w, b = _head_inputs(B, T, torch.bfloat16, g)
        w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
        cases.append((f"row 12 {label} B{B} T{T} (B, C, T)-major x",
                      _launch_head, (x, w, b),
                      head_kernel.synthesis_head_plain(x, w, b, n_fft=48,
                                                       hop=12)))
    names = {_launch_local: "local_attention", _launch_full: "full_attention",
             _launch_local_lse: "local_attention_fwd_lse",
             _launch_bwd_dq: "local_attention_bwd_dq",
             _launch_bwd_dkv: "local_attention_bwd_dkv",
             _launch_convt: "conv_transpose", _launch_adain: "adain_conv",
             _launch_head: "synthesis_head",
             _launch_adain_bwd: "adain_conv_bwd_data",
             _launch_euler: "sampler_euler", _launch_heun: "sampler_heun",
             _launch_istft: "istft"}
    parts = {_launch_local_lse: ("out", "lse"), _launch_bwd_dkv: ("dk", "dv"),
             _launch_euler: ("x", "d")}
    res = {}
    for label, launch, args, ref, *dtype in cases:
        dtype = dtype[0] if dtype else torch.bfloat16
        fns = [lambda lib=lib: launch(lib.lib, *args) for lib in (old, new)]
        name = names[launch]
        for who, fn in zip(("parent", "this"), fns):
            got = fn()
            if launch not in parts:
                check_close(name, who, dtype, got, ref)
                continue
            for part, o, r in zip(parts[launch], got, ref):
                check_close(name, f"{who} {part}", dtype, o, r)
        t, host = zip(*(timed(fns[i], iters=20) for i in (0, 1, 1, 0)))
        speedup = (t[0] + t[3]) / (t[1] + t[2])
        print(f"  {label}: parent {t[0]:.4f} / {t[3]:.4f} ms, this "
              f"{t[1]:.4f} / {t[2]:.4f} ms ({speedup:.2f}x); host per "
              f"launch: parent {host[0]:.4f} / {host[3]:.4f} ms, this "
              f"{host[1]:.4f} / {host[2]:.4f} ms  [{card}]")
        res[label] = {"parent_ms": [t[0], t[3]], "ms": [t[1], t[2]],
                      "parent_host_ms": [host[0], host[3]],
                      "host_ms": [host[1], host[2]]}
    return res


# One tree's 1-step, multi-step, long-form and serving phases with their
# profiles, run from that tree's root (``--paths-against``); a tree whose
# phase_multistep or phase_serve has no ``light`` option runs it whole.
_PATHS_IN_TURNS = """
import inspect
import chip_smoke as cs
card = cs.phase_device()
cs.phase_build()
m = cs.phase_main_path(card)
cs.phase_profile(m["fn"], m["inputs32"], card, "1-step batch 32")
light = "light" in inspect.signature(cs.phase_multistep).parameters
ms = cs.phase_multistep(card, **({"light": True} if light else {}))
cs.phase_profile(ms["fn"], ms["inputs"], card, "multi-step batch 32")
lf = cs.phase_longform(card)[4864]
cs.phase_profile(lf["fn"], lf["inputs"], card, "long-form batch 4 x 4864")
light = "light" in inspect.signature(cs.phase_serve).parameters
sv = cs.phase_serve(card, **({"light": True} if light else {}))
server, reqs = sv.pop("server"), sv.pop("reqs")
cs.phase_profile(lambda: server.serve_batch(reqs), (), card,
                 "serve 256 requests (mel)")
"""


def phase_paths_against_parent(parent: str) -> None:
    """The 1-step (batch 1 and 32), multi-step, long-form and serving (256
    requests) phases, with their profiles, of the tree unpacked at
    ``parent`` and of this one in turns (parent, this, this, parent), each
    in its own process from its own root, on one card."""
    for who, root in (("parent", parent), ("this", REPO), ("this", REPO),
                      ("parent", parent)):
        print(f"== {who}: {Path(root).resolve()}", flush=True)
        rc = subprocess.run([sys.executable, "-c", _PATHS_IN_TURNS],
                            cwd=root).returncode
        if rc != 0:
            raise AssertionError(f"the paths of {root} exited with {rc}")


def _profiled_call(fn, inputs, *, record_shapes: bool):
    """One call of ``fn`` under ``torch.profiler``: (profile, wall us)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        fn(*inputs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def phase_profile(fn, inputs, card: str, label: str) -> None:
    """Device time by kernel for one call and the busy share; then, from a
    second call whose input shapes are recorded (which slows the host, so
    its busy share is not used), the ops that launched the top kernels."""
    fn(*inputs)
    torch.cuda.synchronize()
    prof, wall_us = _profiled_call(fn, inputs, record_shapes=False)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        print("  profiler saw no device time: breakdown not measured")
        return
    print(f"  {label}, one call: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.0f}%), "
          f"{sum(e.count for e in kernels)} kernel launches  [{card}]")
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    gaps, last_end = [], spans[0][1] if spans else 0
    for start, end, name in spans[1:]:
        if start > last_end:
            gaps.append((start - last_end, name))
        last_end = max(last_end, end)
    gaps.sort(reverse=True)
    print(f"    device idle between kernels: "
          f"{sum(g for g, _ in gaps) / 1e3:.1f} ms in {len(gaps)} gaps; "
          f"the longest (ms, the kernel that ended it): "
          + "; ".join(f"{g / 1e3:.2f} {name[:50]}" for g, name in gaps[:5]))
    shaped, _ = _profiled_call(fn, inputs, record_shapes=True)
    launched_by: dict[str, dict] = {}
    for ev in shaped.events():
        for kern in getattr(ev, "kernels", []):
            src = f"{ev.name} {ev.input_shapes}"[:110]
            srcs = launched_by.setdefault(kern.name, {})
            srcs[src] = srcs.get(src, 0) + 1
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")
        srcs = sorted(launched_by.get(e.key, {}).items(), key=lambda kv: -kv[1])
        for src, n_launch in srcs[:3]:
            print(f"             x{n_launch:<4d} from {src}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="only time the twelve rows' kernels against the "
                         "kernels of the tree unpacked at DIR, in turns")
    ap.add_argument("--paths-against", metavar="DIR",
                    help="only run the 1-step, multi-step, long-form and "
                         "serving phases of the tree unpacked at DIR and of "
                         "this one, in turns")
    ap.add_argument("--rank-job", choices=sorted(RANK_JOBS), default=None,
                    help="run as one rank of a phase's process group on "
                         "this card (the mesh and tensor phases start them)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.rank_job is not None:
        rank_worker(args.rank_job, args.rank, args.world, args.port,
                    Path(args.out))
        return
    with phase("device"):
        card = phase_device()
    with phase("build"):
        phase_build()
    if args.against:
        with phase("against parent"):
            print(json.dumps({"against": phase_against_parent(args.against,
                                                              card)}))
        return
    if args.paths_against:
        with phase("paths against parent"):
            phase_paths_against_parent(args.paths_against)
        return
    with phase("kernels"):
        checks = phase_kernel_checks(card)
    with phase("istft_head"):
        istft_head = phase_istft_head(card)
    with phase("main path"):
        main_res = phase_main_path(card)
    with phase("profile"):
        phase_profile(main_res["fn"], main_res["inputs32"], card,
                      "1-step batch 32")
    with phase("multi-step"):
        multi = phase_multistep(card)
    with phase("profile multi-step"):
        phase_profile(multi["fn"], multi["inputs"], card,
                      "multi-step batch 32")
    with phase("long-form"):
        longf = phase_longform(card)
    with phase("profile long-form"):
        lf = longf[4864]
        phase_profile(lf["fn"], lf["inputs"], card, "long-form batch 4 x 4864")
    with phase("train_stage1"):
        train = phase_train(card)
    with phase("profile train_stage1"):
        phase_profile(train["fn"], train["inputs"], card,
                      "stage-1 train step, batch 16 x 1024")
    with phase("train_stage2"):
        stage2 = phase_train_stage2(card)
    with phase("profile train_stage2"):
        phase_profile(stage2["fn"], stage2["inputs"], card,
                      "stage-2 train step, batch 16 x 1024")
    with phase("train_stage3"):
        stage3 = phase_train_stage3(card)
    with phase("profile train_stage3"):
        phase_profile(stage3["fn"], stage3["inputs"], card,
                      "stage-3 train step, batch 16 x 1024")
    with phase("corpus"):
        corpus_res = phase_corpus(card)
    with phase("pipeline"):
        pipe = phase_pipeline(card)
    with phase("serve"):
        serve = phase_serve(card)
    with phase("profile serve"):
        server, reqs = serve.pop("server"), serve.pop("reqs")
        phase_profile(lambda: server.serve_batch(reqs), (), card,
                      "serve 256 requests (mel)")
    with phase("mesh"):
        mesh_res = phase_mesh(card, {"server": server, "reqs": reqs})
        del server
    with phase("tensor"):
        mesh_res.update(phase_tensor(card))
    with phase("verify"):
        verify = phase_verify(card)
    with phase("acceptance"):
        accept = phase_acceptance(card)
    paths = {"one_step": (main_res["counts"], main_res["n_calls"]),
             "multi_step": (multi["counts"], multi["n_calls"]),
             "long_form": (lf["counts"], lf["n_calls"]),
             "long_form_2048": (longf[2048]["counts"], longf[2048]["n_calls"]),
             "train_stage1": (train["counts"], train["n_calls"]),
             "train_stage2": (stage2["counts"], stage2["n_calls"]),
             "train_stage3": (stage3["counts"], stage3["n_calls"]),
             "train_stage1_corpus_mas": (corpus_res["train"]["counts"],
                                         corpus_res["train"]["n_calls"]),
             "eval": (corpus_res["eval"]["counts"],
                      corpus_res["eval"]["n_calls"]),
             "pipeline": (pipe["counts"], pipe["n_calls"]),
             **{name: (r["counts"], r["n_calls"])
                for name, r in mesh_res.items()},
             **{name: (r["counts"], r["n_calls"]) for name, r in serve.items()},
             "verify": (verify["counts"], verify["n_calls"]),
             "acceptance_level2": (accept["counts"], accept["n_calls"]),
             "istft_head": (istft_head["counts"], istft_head["n_calls"])}
    kernels = []
    for name, c in checks.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(counts[name] for counts, _ in paths.values()),
            "launches_per_call": {path: counts[name] / n for path, (counts, n)
                                  in paths.items()},
            **c})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
