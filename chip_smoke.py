#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and
the CUDA toolkit.  In order it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the three kernels from setk_tpu_torch/csrc (one nvcc per
     source, all at once) and prints the build time and ptxas' register
     and spill counts;
  3. holds each kernel against its plain PyTorch version on the card at
     the bench shape (B=128, N=6, 8 s at 16 kHz, int16 audio, mask
     uniform on [0, 1) from numpy.random.default_rng(0)): max |diff| /
     max |plain| must stay <= 1e-4;
  4. runs BatchEnhancer(device="cuda", batch_size=128) over 128 keyed
     8 s utterances and a few other lengths (buckets of T = 513, 449 and
     193 frames), with the launch counts set to 0 just before and read
     just after; every kernel must have launched, every output must be
     finite, match the plain path on the card within 1e-4 of its peak
     and correlate with the clean source;
  5. times each kernel, its plain version and enhance_batch with CUDA
     events (warm-up, then 20 launches) and prints the kernels line;
  6. prints {"ok": true, "device": {...}} as the last line.
Any failure raises and exits non-zero.  Without a CUDA device, or
without the setk_tpu_torch package beside this file, it exits 2 and
prints no result.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

B, N, SECS, SR = 128, 6, 8, 16000
S = SECS * SR
TOL = 1e-4
ITERS = 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def _abs(got, ref) -> float:
    return float((got - ref).abs().max())


def _rel(got, ref) -> float:
    return _abs(got, ref) / float(ref.abs().max())


def _time_ms(torch, fn, iters=ITERS, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    beg = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    beg.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return beg.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Operation counts of the kernels' own algorithms (see the notes in
# setk_tpu_torch/csrc): a 512-point complex radix-2 FFT is 9 stages x
# 256 butterflies x 10 FLOP; each FFT carries two mics.
FFT512_FLOP = 9 * 256 * 10


def _flops_stft_covar(b, n, t):
    pairs = (n + 1) // 2
    per_frame = n * 512 + pairs * FFT512_FLOP + 257 * (
        pairs * 8 + n * 7 + 14 * n * (n - 1) // 2)
    return b * t * per_frame


def _flops_mvdr(bins, n, iters):
    per_bin = iters * (8 * n * n + 4 * n) + 4 * n**3 // 3 + 16 * n * n
    return bins * per_bin


def _flops_beamform_istft(b, n, t):
    pairs = (n + 1) // 2
    fwd = n * 512 + pairs * FFT512_FLOP + 257 * (pairs * 8 + n * 8)
    inv = FFT512_FLOP / 2 + 512 * 3
    return b * t * (fwd + inv)


def _ptxas_summary(log: str) -> dict:
    """Registers, spills and shared memory per kernel instance from
    nvcc's -Xptxas -v log, keyed like "stft_covar<6,int16>"."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(mvdr_power|stft_covar|beamform_istft)"
                      r"_kernelILi(\d)E([fs]?)E", line)
        if "Compiling entry function" in line and m:
            dtype = {"f": ",f32", "s": ",int16"}.get(m.group(3), "")
            key = f"{m.group(1)}<{m.group(2)}{dtype}>"
            out[key] = {}
        elif key and "spill stores" in line:
            out[key]["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif key and "registers" in line:
            out[key]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[key]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "setk_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: setk_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import numpy as np
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.dsp.window import wss_inverse_blocks
    from setk_tpu_torch.enhance.pipeline import enhance_plain
    from setk_tpu_torch.ops.cuda import _build
    from setk_tpu_torch.ops.cuda import fused_mvdr as fm
    from setk_tpu_torch.ops.cuda import mvdr as mv
    from setk_tpu_torch.parallel.enhance_step import enhance_batch
    from setk_tpu_torch.parallel.executor import BatchEnhancer, LengthBucketer

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))

    # ---- 2. build ----
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    (_build.BUILD_DIR / "ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"build: {build_s:.1f} s for {len(logs)} libraries")
    print(json.dumps({"ptxas": _ptxas_summary("\n".join(logs.values()))}))

    # ---- 3. kernels against their plain versions at the bench shape ----
    cfg = StftConfig()
    t_frames = cfg.num_frames(S)
    rng = np.random.default_rng(0)
    clean = rng.standard_normal((B, S)).astype(np.float32) * 0.2
    wav = (np.stack([clean] * N, axis=1) +
           rng.standard_normal((B, N, S)).astype(np.float32) * 0.05)
    wav16 = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    mask = rng.random((B, t_frames, cfg.num_bins)).astype(np.float32)
    wav_d = torch.from_numpy(wav16).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    wss_inv = torch.as_tensor(wss_inverse_blocks(
        cfg.padded_window, t_frames, cfg.frame_hop, cfg.n_fft, S),
        device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rs_k, rn_k = fm.stft_covar(wav_d, mask_d, window)
    rs_p, rn_p = fm.stft_covar_plain(wav_d, mask_d, window)
    err_a = max(_rel(rs_k, rs_p), _rel(rn_k, rn_p))
    abs_a = max(_abs(rs_k, rs_p), _abs(rn_k, rn_p))
    den_s = mask_d.sum(1)
    rs = (rs_p / torch.clamp(den_s, min=1e-6)[..., None, None]).contiguous()
    rn = (rn_p / torch.clamp(t_frames - den_s, min=1e-6)[..., None, None]
          ).contiguous()
    w_k = mv.mvdr_power(rs, rn)
    w_p = mv.mvdr_power_plain(rs, rn)
    err_m, abs_m = _rel(w_k, w_p), _abs(w_k, w_p)
    out_k = fm.beamform_istft(wav_d, w_k, wss_inv, window)
    out_p = fm.beamform_istft_plain(wav_d, w_k, wss_inv, window)
    err_b, abs_b = _rel(out_k, out_p), _abs(out_k, out_p)
    torch.cuda.synchronize()
    errs = {"stft_covar": err_a, "mvdr_power": err_m,
            "beamform_istft": err_b}
    abs_errs = {"stft_covar": abs_a, "mvdr_power": abs_m,
                "beamform_istft": abs_b}
    print(json.dumps({"kernel_vs_plain_max_rel_err": errs, "tol": TOL}))
    for name, err in errs.items():
        if not err <= TOL:
            raise AssertionError(f"{name}: kernel vs plain {err} > {TOL}")

    # ---- 4. the main path: BatchEnhancer over keyed utterances ----
    extra = {"x0": 100000, "x1": 100000, "x2": 40000, "x3": 131000,
             "x4": 40000}
    utts = {f"u{i:03d}": (wav16[i], mask[i], clean[i]) for i in range(B)}
    for key, length in extra.items():
        c = rng.standard_normal(length).astype(np.float32) * 0.2
        x = (np.stack([c] * N) +
             rng.standard_normal((N, length)).astype(np.float32) * 0.05)
        utts[key] = (np.clip(x * 32768, -32768, 32767).astype(np.int16),
                     rng.random((cfg.num_frames(length), cfg.num_bins)
                                ).astype(np.float32), c)
    counted = (fm.stft_covar, mv.mvdr_power, fm.beamform_istft)
    enhancer = BatchEnhancer(cfg, batch_size=B, device="cuda")
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    results = {}
    for key, (x, m, _) in utts.items():
        results.update(enhancer.add(key, x, m))
    results.update(enhancer.flush())
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    print(json.dumps({"main_path_launches": launches,
                      "utterances": len(results), "seconds": e2e_s}))
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} never launched on the main path")
    if set(results) != set(utts):
        raise AssertionError("BatchEnhancer lost utterances")

    # the plain path on the card, bucket by bucket as BatchEnhancer pads
    bucketer = LengthBucketer(cfg)
    buckets = {}
    for key, (x, m, _) in utts.items():
        buckets.setdefault(bucketer.bucket(x.shape[-1]), []).append(key)
    worst, frames_seen = 0.0, []
    for bucket, keys in buckets.items():
        t_pad = cfg.num_frames(bucket)
        frames_seen.append(t_pad)
        wv = np.zeros((len(keys), N, bucket), np.int16)
        mk = np.zeros((len(keys), t_pad, cfg.num_bins), np.float32)
        for i, key in enumerate(keys):
            x, m, _ = utts[key]
            wv[i, :, :x.shape[-1]] = x
            mk[i, :m.shape[0]] = m[:t_pad]
        ref = enhance_plain(torch.from_numpy(wv).to(dev),
                            torch.from_numpy(mk).to(dev), cfg,
                            nsamps=bucket).cpu().numpy()
        for i, key in enumerate(keys):
            got = results[key]
            x, _, c = utts[key]
            if got.shape != (x.shape[-1],) or not np.isfinite(got).all():
                raise AssertionError(f"{key}: bad output {got.shape}")
            r = ref[i, :x.shape[-1]]
            worst = max(worst, float(np.abs(got - r).max() / np.abs(r).max()))
            corr = float(np.corrcoef(got, c)[0, 1])
            if corr < 0.9:
                raise AssertionError(f"{key}: correlation with the clean "
                                     f"source {corr} < 0.9")
    print(json.dumps({"main_path_vs_plain_max_rel_err": worst,
                      "bucket_frames": sorted(frames_seen), "tol": TOL}))
    if not worst <= TOL:
        raise AssertionError(f"main path vs plain {worst} > {TOL}")
    if max(frames_seen) <= 512:
        raise AssertionError("no bucket with T > 512 was driven")

    # ---- 5. timing at the bench shape ----
    wav_f = (wav_d.float() / 32768.0).contiguous()
    frames = torch.nn.functional.pad(
        wav_f.reshape(B * N, 1, S), (256, 256), mode="reflect"
    ).reshape(B, N, S + 512).unfold(-1, 512, 256) * window
    rfft_ms = _time_ms(torch, lambda: torch.fft.rfft(frames, dim=-1))
    w_d = w_k
    rows = [
        ("stft_covar", "setk_tpu/ops/pallas/fused_mvdr.py:321",
         lambda: fm.stft_covar(wav_d, mask_d, window),
         lambda: fm.stft_covar_plain(wav_d, mask_d, window),
         _bound(wav_d.nbytes + mask_d.nbytes + 2 * rs_k.nbytes,
                _flops_stft_covar(B, N, t_frames))),
        ("mvdr_power", "setk_tpu/ops/pallas/mvdr.py:458",
         lambda: mv.mvdr_power(rs, rn),
         lambda: mv.mvdr_power_plain(rs, rn),
         _bound(rs.nbytes + rn.nbytes + w_k.nbytes,
                _flops_mvdr(B * cfg.num_bins, N, 15))),
        ("beamform_istft", "setk_tpu/ops/pallas/fused_mvdr.py:430",
         lambda: fm.beamform_istft(wav_d, w_d, wss_inv, window),
         lambda: fm.beamform_istft_plain(wav_d, w_d, wss_inv, window),
         _bound(wav_d.nbytes + w_d.nbytes + wss_inv.nbytes + out_k.nbytes,
                _flops_beamform_istft(B, N, t_frames))),
    ]
    source = {"stft_covar": "setk_tpu_torch/csrc/fused_mvdr.cu",
              "mvdr_power": "setk_tpu_torch/csrc/mvdr_power.cu",
              "beamform_istft": "setk_tpu_torch/csrc/fused_mvdr.cu"}
    kernels = []
    for name, replaces, run_k, run_p, (bound_ms, bound_by) in rows:
        ms = _time_ms(torch, run_k)
        plain_ms = _time_ms(torch, run_p)
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": abs_errs[name], "max_rel_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    step_ms = _time_ms(torch, lambda: enhance_batch(
        wav_d, mask_d, cfg, beamformer="mvdr"))
    plain_step_ms = _time_ms(torch, lambda: enhance_plain(
        wav_d, mask_d, cfg), iters=5, warmup=1)
    print(json.dumps({
        "card": smi, "enhance_batch_ms": step_ms,
        "audio_s_per_s": B * SECS / (step_ms / 1e3),
        "plain_path_ms": plain_step_ms, "rfft_frames_ms_info": rfft_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
