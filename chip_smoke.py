#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``styletts_zs_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles ``styletts_zs_torch/csrc/*.cu`` with one nvcc call
               (``-Xptxas -v`` register/shared-memory lines printed);
  3. kernels — each hand-written kernel against its plain PyTorch version at
               the main path's shapes, fp32 and bf16, masked and unmasked,
               with kernel / plain / library times from CUDA events;
  4. main    — zero-shot 1-step synthesis with the vocoder at full width
               (``bench.py``'s configuration: 256 phonemes, 1024 frames,
               bf16, weights from a seed) at batch 1 and 32, checking the
               waveforms, the kernel launch counts per call, audio-s/s,
               the real-time factor, peak memory, and the mel MAE against
               the fp32 plain path on the CPU.
Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; without a CUDA device it stops in
phase 1.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from styletts_zs_torch.config import Config, ModelConfig, RuntimeConfig  # noqa: E402
from styletts_zs_torch.kernels import build, dispatch  # noqa: E402
from styletts_zs_torch.kernels import local_attention as la_kernel  # noqa: E402
from styletts_zs_torch.kernels import synthesis_head as head_kernel  # noqa: E402
from styletts_zs_torch.ops.attention import length_mask  # noqa: E402
from styletts_zs_torch.pipelines.factory import init_params  # noqa: E402
from styletts_zs_torch.pipelines.infer import make_synthesis_fn  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak

# Tolerances of the kernel checks: |kernel - plain| <= atol + rtol * |plain|
# everywhere.  fp32: the two sum the same products in another order
# (~1e-6 relative).  bf16: the output is rounded to bf16 (2^-9 relative,
# one step is 0.016 at |x| in [2, 4)), and the plain version rounds the
# probabilities / sums the head conv in another order before rounding it
# to bf16, so a value can land one bf16 step apart before exp() and the
# overlap-add.
TOL = {
    "local_attention": {torch.float32: (1e-5, 1e-5),
                        torch.bfloat16: (1e-2, 1e-2)},
    "synthesis_head": {torch.float32: (1e-4, 1e-4),
                       torch.bfloat16: (2e-2, 2e-2)},
}
# The untrained duration head predicts log-durations near 0, which round to
# 0 frames: every utterance would be empty.  Its bias is set so that the
# 256 phonemes fill most of the 1024-frame bucket, as trained weights do.
DURATION_BIAS = float(np.log1p(3.5))
# fp32 on the card against fp32 on the CPU, through the whole path: the same
# arithmetic summed in another order through ~40 layers.
FP32_PATH_TOL = 1e-3
SOURCES = {
    "local_attention": ("styletts_zs_torch/csrc/local_attention.cu",
                        "styletts_zs_tpu/kernels/attention_kernel.py:35"),
    "synthesis_head": ("styletts_zs_torch/csrc/synthesis_head.cu",
                       "styletts_zs_tpu/kernels/vocoder_kernels.py:341"),
}


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def bench_config() -> Config:
    """``bench.py``'s full-width configuration."""
    return Config(model=ModelConfig(max_text_len=256, max_frames=1024),
                  runtime=RuntimeConfig(compute_dtype="bfloat16"))


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def check_close(name: str, label: str, dtype, out, ref) -> float:
    """Hold ``out`` against ``ref`` with the stated tolerance; returns the
    max abs error."""
    atol, rtol = TOL[name][dtype]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - rtol * ref.float().abs()).max().item()
    print(f"  {name:15s} {str(dtype)[6:]:8s} {label:6s} max_abs_err "
          f"{err:.3e} (tol {atol:.0e} + {rtol:.0e}*|plain|, max |plain| "
          f"{ref.float().abs().max().item():.3f})")
    if not excess <= atol:
        raise AssertionError(f"{name} {dtype} {label}: max_abs_err {err}, "
                             f"exceeds atol {atol} + rtol {rtol}*|plain| "
                             f"by {excess - atol}")
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> build.KernelLibrary:
    lib = build.library()
    print(f"built {lib.path.name} in {lib.build_seconds:.1f} s "
          f"(one nvcc call, {len(build.sources())} sources)")
    for line in lib.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print("  " + line.strip())
    return lib


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def _attention_inputs(dtype, masked: bool, g: torch.Generator):
    """(B 32, T 1024, H 8, D 64) q/k/v as strided views of one fused qkv
    projection, as the decoder hands them over."""
    B, T, H, D = 32, 1024, 8, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device="cuda").to(dtype)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    if masked:
        lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
        lengths[:4] = torch.tensor([0, 1, 256, 700], device="cuda")
    else:
        lengths = torch.full((B,), T, device="cuda")
    return q, k, v, lengths.to(torch.int32)


def _attention_work(lengths: torch.Tensor, T: int, H: int, D: int,
                    chunk: int, itemsize: int):
    """Bytes and matmul FLOPs this call needs: q/k/v read once, out written
    once; QK^T and PV over the (query, key) pairs in band and length."""
    n_bytes = 4 * lengths.numel() * T * H * D * itemsize + 4 * lengths.numel()
    t = np.arange(T)
    ci = t // chunk
    lo = np.maximum((ci - 1) * chunk, 0)
    hi = np.minimum((ci + 2) * chunk, T)
    pairs = 0
    for L in lengths.tolist():
        pairs += int(np.clip(np.minimum(hi, L) - lo, 0, None).sum())
    return n_bytes, pairs * H * 4 * D


def check_local_attention(chunk: int = 256) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            q, k, v, lengths = _attention_inputs(dtype, masked, g)
            out = la_kernel.local_attention_cuda(q, k, v, lengths, chunk=chunk)
            ref = la_kernel.local_attention_plain(q, k, v, lengths, chunk=chunk)
            torch.cuda.synchronize()
            errs.append(check_close("local_attention",
                                    "masked" if masked else "full",
                                    dtype, out, ref))
    # times at the production dtype, masked
    B, T, H, D = q.shape
    ms = cuda_ms(lambda: la_kernel.local_attention_cuda(q, k, v, lengths,
                                                        chunk=chunk))
    plain_ms = cuda_ms(lambda: la_kernel.local_attention_plain(
        q, k, v, lengths, chunk=chunk), iters=3)
    t = torch.arange(T, device="cuda")
    band = ((t[:, None] // chunk) - (t[None, :] // chunk)).abs() <= 1
    mask = band[None, None] & length_mask(lengths, T)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), iters=5)
    n_bytes, flops = _attention_work(lengths.cpu(), T, H, D, chunk, 2)
    bms, by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    print(f"  local_attention bf16 B{B} T{T} H{H} D{D} c{chunk}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, "
          f"bound {bms:.4f} ms ({by})")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms}


def check_synthesis_head(n_fft: int = 48, hop: int = 12, K: int = 7) -> dict:
    g = torch.Generator(device="cuda").manual_seed(2)
    B, T, C = 32, 25600, 128
    n_freq = n_fft // 2 + 1
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        x = (0.5 * torch.randn(B, T, C, generator=g, device="cuda")).to(dtype)
        w = torch.randn(K, C, 3 * n_freq, generator=g, device="cuda") \
            * (K * C) ** -0.5
        b = 0.1 * torch.randn(3 * n_freq, generator=g, device="cuda")
        out = head_kernel.synthesis_head_cuda(x, w, b, n_fft=n_fft, hop=hop)
        ref = head_kernel.synthesis_head_plain(x, w, b, n_fft=n_fft, hop=hop)
        torch.cuda.synchronize()
        if out.shape != ref.shape:
            raise AssertionError(f"head shape {out.shape} vs {ref.shape}")
        errs.append(check_close("synthesis_head", "", dtype, out, ref))
    ms = cuda_ms(lambda: head_kernel.synthesis_head_cuda(x, w, b, n_fft=n_fft,
                                                         hop=hop))
    plain_ms = cuda_ms(lambda: head_kernel.synthesis_head_plain(
        x, w, b, n_fft=n_fft, hop=hop), iters=3)
    out_len = (T - 1) * hop
    M = (n_fft - 1) // hop + 1
    n_bytes = (x.numel() * 2 + K * C * 3 * n_freq * 2 + 3 * n_freq * 2
               + B * out_len * 4)
    flops = 2 * B * T * K * C * 3 * n_freq + 2 * B * out_len * M * 2 * n_freq
    bms, by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    print(f"  synthesis_head bf16 B{B} T{T} C{C} K{K} n_fft{n_fft} hop{hop}: "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
          f"({by})")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def phase_kernel_checks() -> dict:
    return {"local_attention": check_local_attention(),
            "synthesis_head": check_synthesis_head()}


# ---------------------------------------------------------------------------
# phase 4: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

def reset_counts() -> None:
    la_kernel.launches = 0
    head_kernel.launches = 0
    for name in dispatch.plain_calls:
        dispatch.plain_calls[name] = 0


def kernel_counts(device: torch.device) -> dict:
    """CUDA launches on the card; plain-version calls on the CPU."""
    if device.type == "cuda":
        return {"local_attention": la_kernel.launches,
                "synthesis_head": head_kernel.launches}
    return dict(dispatch.plain_calls)


def expected_counts(cfg: Config, n_frames: int) -> dict:
    """Kernel calls one synthesis call makes: one local attention per decoder
    attention block (when the frame count is inside the gate) and one head."""
    d, v = cfg.model.decoder, cfg.model.vocoder
    n_attn = sum(1 for i in range(d.n_blocks) if (i + 1) % d.attn_every == 0)
    head_ok = head_kernel.supported(
        n_fft=v.istft_n_fft, hop=v.istft_hop, K=7,
        dtype=getattr(torch, cfg.runtime.compute_dtype))
    return {"local_attention": n_attn if la_kernel.supported(
                n_frames, d.attn_window) else 0,
            "synthesis_head": 1 if head_ok else 0}


def synth_inputs(cfg: Config, batch: int, device, seed: int = 0):
    """``bench.py``'s inputs: full-length random phonemes, a 3 s reference
    mel, and the sampler's initial noise, all from one seed."""
    m = cfg.model
    g = torch.Generator().manual_seed(seed)
    Tt = m.max_text_len
    ref_frames = 3 * m.audio.sample_rate // m.audio.hop_length
    phonemes = torch.randint(1, 40, (batch, Tt), generator=g)
    ref_mel = 0.5 * torch.randn(batch, ref_frames, m.audio.n_mels, generator=g)
    noise = torch.randn(batch, m.style.n_codes, m.style.d_style, generator=g)
    return (phonemes.to(device),
            torch.full((batch,), Tt, dtype=torch.int32, device=device),
            ref_mel.to(device),
            torch.full((batch,), ref_frames, dtype=torch.int32, device=device),
            noise.to(device))


def drive_main_path(cfg: Config, fn, inputs, *, device, n_calls: int) -> dict:
    """Run ``fn`` ``n_calls`` times, each timed to its end, with the kernel
    counts set to 0 just before and read just after; check the counts,
    shapes and finiteness."""
    device = torch.device(device)
    n_frames = cfg.model.max_frames
    expect = expected_counts(cfg, n_frames)
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
    for name, per_call in expect.items():
        if per_call == 0 or counts[name] != per_call * n_calls:
            raise AssertionError(f"{name}: {counts[name]} calls in {n_calls} "
                                 f"synthesis calls, expected {per_call} each")
    B = inputs[0].shape[0]
    n_up = int(np.prod(cfg.model.vocoder.upsample_rates))
    n_samples = (n_frames * n_up - 1) * cfg.model.vocoder.istft_hop
    if wav.shape != (B, n_samples) or not torch.isfinite(wav).all():
        raise AssertionError(f"waveform {tuple(wav.shape)} (expected "
                             f"{(B, n_samples)}) finite="
                             f"{bool(torch.isfinite(wav).all())}")
    if not torch.isfinite(out.mel.float()).all():
        raise AssertionError("mel not finite")
    return {"seconds": float(np.median(times)), "times": times,
            "counts": counts, "per_call": expect, "out": out, "wav": wav}


def mel_mae(out, ref_out) -> float:
    """Masked mel MAE against the reference's frame mask (``bench.py``)."""
    mask = ref_out.frame_mask.cpu()[..., None].float()
    diff = (out.mel.float().cpu() - ref_out.mel.float().cpu()).abs() * mask
    return float(diff.sum() / max(float(mask.sum()) * out.mel.shape[-1], 1.0))


def phase_main_path(card: str) -> dict:
    cfg = bench_config()
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
              f"in {n_calls} calls ({r['per_call']} per call), peak memory "
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
    return {"launches": res[1]["counts"], "fn": fn,
            "inputs32": synth_inputs(cfg, 32, "cuda")}


def phase_profile(fn, inputs, card: str) -> None:
    """Device time by kernel for one batch-32 call, and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    fn(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*inputs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        print("  profiler saw no device time: breakdown not measured")
        return
    print(f"  batch 32, one call: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.0f}%), "
          f"{sum(e.count for e in kernels)} kernel launches  [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<4d} {e.key[:90]}")


def main() -> None:
    with phase("device"):
        card = phase_device()
    with phase("build"):
        phase_build()
    with phase("kernels"):
        checks = phase_kernel_checks()
    with phase("main path"):
        main_res = phase_main_path(card)
    with phase("profile"):
        phase_profile(main_res["fn"], main_res["inputs32"], card)
    kernels = []
    for name, c in checks.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_res["launches"][name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
