#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and
the CUDA toolkit.  In order it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernels from setk_tpu_torch/csrc (one nvcc per source,
     all at once) and prints the build time and ptxas' register and
     spill counts;
  3. holds kernel A, the MVDR solve and kernel B against their plain
     PyTorch versions on the card at the bench shape (B=128, N=6, 8 s at
     16 kHz, int16 audio, mask uniform on [0, 1) from
     numpy.random.default_rng(0)): max |diff| / max |plain| <= 1e-4;
  4. runs BatchEnhancer(device="cuda", batch_size=128) over 128 keyed
     8 s utterances and a few other lengths (buckets of T = 513, 449 and
     193 frames), with the launch counts set to 0 just before and read
     just after; every kernel must have launched, every output must be
     finite, match the plain path on the card within 1e-4 of its peak
     and correlate with the clean source;
  5. on a gated scene at the same width (a source in on/off bursts,
     delayed a sample and attenuated per mic, noise at 0.05, a 0.95/0.05
     mask that follows the bursts; the uniform mask makes Rs and Rn
     proportional, where GEVD and PMWF have no defined answer) holds the
     family's solve kernels (gevd_power at 30 and 50 iterations,
     pmwf_solve at beta 0 and 1 with powers, capon) against their plain
     versions on kernel A's covariances: 1e-4 of the peak, or for
     gevd_power the JAX package's Rayleigh-quotient contract
     (tests/test_pallas.py:466-481) where near-degenerate bins miss it;
  6. drives each of gevd, gevd+BAN, pmwf-0, pmwf-1, mpdr and mpdr-whiten
     through BatchEnhancer over the gated scene (one bucket of 128 x 8 s,
     T = 513, and one of 4 x 3 s, T = 193), counts reset before and read
     after each: exactly the name's kernels launched, outputs finite,
     within 1e-4 of enhance_plain(beamformer=X) on the card and, for the
     distortionless names, correlating >= 0.9 with the source as mic 0
     sees it;
  7. online (chunked EMA) MVDR at the bench shape with chunk 32 and
     alpha 0.8: holds kernel A's per-chunk sums, covar_ema and
     beamform_istft_online against their plain versions (1e-4 of the
     peak); runs BatchEnhancer(chunk_size=32) over step 4's utterances
     (T = 513/449/193) and BatchEnhancer(chunk_size=24) over its extra
     lengths, counts reset before and read after each: exactly
     stft_covar, covar_ema, mvdr_power and beamform_istft_online
     launched, outputs finite, within 1e-4 of enhance_plain_online on the
     card and correlating >= 0.9 with the clean source; times streaming
     enhancement of one 4 s utterance (chunk 32), per call and per chunk;
  8. runs the CLI (apply_adaptive_beamformer --batch-size 4) on the card
     over 6 utterances (6 ch, 3-8 s, int16 wav files, numpy masks) in a
     temporary directory under setk_tpu_torch/_build, offline mvdr and
     with --chunk-size 32: every key written and finite, and each file
     within 2 int16 steps of the same CLI run with --device cpu;
  9. times each kernel (20 launches replayed from one CUDA graph, so the
     wrapper's host work is not counted; the eager per-call time beside
     it), its plain version and enhance_batch for every name and for the
     online path with CUDA events (warm-up, then 20 calls) and prints the
     kernels line;
  10. prints {"ok": true, "device": {...}} as the last line.
Any failure raises and exits non-zero.  Without a CUDA device, or
without the setk_tpu_torch package beside this file, it exits 2 and
prints no result.
"""

import json
import re
import subprocess
import sys
import tempfile
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


def _graph_ms(torch, fn, iters=ITERS) -> float:
    """Device time per call of ``fn`` without the host's launch overhead:
    ``iters`` calls captured in one CUDA graph, replayed and timed with
    events.  Eager timing of a kernel shorter than its Python wrapper's
    host work (~20-40 us) measures the host instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    beg = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    beg.record()
    graph.replay()
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


def _chol_flops(n):
    return 4 * n**3 // 3


def _solve_flops(n):
    # forward and back substitution (complex multiply-subtract, 8 FLOP)
    # plus the pivot and equilibration scalings
    return 8 * n * (n - 1) + 12 * n


def _flops_gevd(bins, n, iters):
    per_iter = 8 * n * n + _solve_flops(n) + 6 * n
    return bins * (_chol_flops(n) + iters * per_iter + 8 * n * n + 12 * n)


def _flops_pmwf(bins, n):
    powers = 2 * n * (8 * n * n + 4 * n)
    return bins * (_chol_flops(n) + n * _solve_flops(n) + 8 * n * n + powers)


def _flops_capon(bins, n):
    return bins * (_chol_flops(n) + _solve_flops(n) + 16 * n)


def _flops_covar_ema(b, n, t, chunks):
    """Per (utterance, bin): the mask sums over every frame, then per
    chunk 2 N (N+1) real numerators divided and blended (4 FLOP each)."""
    return b * 257 * (3 * t + chunks * 2 * n * (n + 1) * 5)


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
        m = re.search(r"(mvdr_power|gevd_power|pmwf_solve|capon|stft_covar"
                      r"|covar_ema|beamform_istft_online|beamform_istft)"
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


def _gated_scene(b, n, s, seed):
    """(wav int16 (B, N, S), mask (B, T, 257), source at mic 0 (B, S)):
    a source at 0.2 in on/off bursts of 2048 samples, delayed one sample
    and attenuated 1/(1 + k/4) at mic k (nearest mic 0, so PMWF's
    SNR-selected reference is mic 0), noise at 0.05, and a 0.95/0.05 mask
    that follows the bursts per frame, as tests/test_pallas.py:413-424
    builds it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gate = (np.arange(s) // 2048) % 2 == 0
    src = (rng.standard_normal((b, s)) * 0.2 * gate).astype(np.float32)
    wav = rng.standard_normal((b, n, s)).astype(np.float32) * 0.05
    for k in range(n):
        wav[:, k] += np.roll(src, k, axis=-1) / (1 + k / 4)
    wav16 = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    t = s // 256 + 1
    gate_f = gate[np.minimum(np.arange(t) * 256, s - 1)]
    mask = np.ascontiguousarray(np.broadcast_to(
        np.where(gate_f, 0.95, 0.05)[None, :, None], (b, t, 257)),
        dtype=np.float32)
    return wav16, mask, src


# (name, ban) of the family's path, with the solve kernels each needs
FAMILY = [(("gevd", False), ("gevd_power",)),
          (("gevd", True), ("gevd_power",)),
          (("pmwf-0", False), ("pmwf_solve",)),
          (("pmwf-1", False), ("pmwf_solve",)),
          (("mpdr", False), ("mvdr_power",)),
          (("mpdr-whiten", False), ("gevd_power", "capon"))]


CHUNK, ALPHA = 32, 0.8


def _write_corpus(root, seed):
    """Six 6-channel int16 wav files of 3-8 s (a clean source on every
    mic plus noise) with uniform [0, 1) masks as .npy, and their scps."""
    import numpy as np
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.io.wave import write_wav
    cfg = StftConfig()
    rng = np.random.default_rng(seed)
    wav_lines, mask_lines = [], []
    for i, secs in enumerate((3, 4, 5, 6, 7, 8)):
        s = secs * SR + 37 * i
        clean = rng.standard_normal(s).astype(np.float32) * 0.2
        x = clean + rng.standard_normal((N, s)).astype(np.float32) * 0.05
        write_wav(root / f"c{i}.wav", x, sr=SR)
        np.save(root / f"c{i}.npy", rng.random(
            (cfg.num_frames(s), cfg.num_bins)).astype(np.float32))
        wav_lines.append(f"c{i} {root}/c{i}.wav")
        mask_lines.append(f"c{i} {root}/c{i}.npy")
    (root / "wav.scp").write_text("\n".join(wav_lines) + "\n")
    (root / "mask.scp").write_text("\n".join(mask_lines) + "\n")
    return [f"c{i}" for i in range(6)]


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
    from setk_tpu_torch.enhance.beamformer import fix_steer_phase
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

    # ---- 5. the family's solve kernels against their plain versions ----
    gwav16, gmask, gsrc = _gated_scene(B, N, S, seed=1)
    gwav_d = torch.from_numpy(gwav16).to(dev)
    gmask_d = torch.from_numpy(gmask).to(dev)
    rs_num, rn_num = fm.stft_covar(gwav_d, gmask_d, window)
    gden = gmask_d.sum(1)
    grs = (rs_num / torch.clamp(gden, min=1e-6)[..., None, None]).contiguous()
    grn = (rn_num / torch.clamp(t_frames - gden, min=1e-6)[..., None, None]
           ).contiguous()
    gry = ((rs_num + rn_num) / t_frames).contiguous()
    hrs = 0.5 * (grs + grs.conj().transpose(-1, -2))
    hrn = 0.5 * (grn + grn.conj().transpose(-1, -2))

    def rayleigh(v):
        num = torch.einsum("...a,...ab,...b->...", v.conj(), hrs, v).real
        den = torch.einsum("...a,...ab,...b->...", v.conj(), hrn, v).real
        return num / torch.clamp(den, min=1e-12)

    fam_errs, fam_abs, checks = {}, {}, {}
    for iters in (30, 50):
        v_k = mv.gevd_power(grs, grn, power_iters=iters)
        v_p = mv.gevd_power_plain(grs, grn, power_iters=iters)
        err = _rel(v_k, v_p)
        key = f"gevd_power_{iters}"
        fam_errs[key], fam_abs[key] = err, _abs(v_k, v_p)
        if err <= TOL:
            checks[key] = "plain within tol"
            continue
        # the JAX package's contract for this kernel: v^H Rn v = 1 and
        # the generalized Rayleigh quotient of the plain version's vector
        q = torch.einsum("...a,...ab,...b->...", v_k.conj(), hrn, v_k).real
        ratio = rayleigh(v_k) / torch.clamp(rayleigh(v_p), min=1e-12)
        checks[key] = {"contract": "rayleigh",
                       "max_abs_vHRnv_minus_1": float((q - 1).abs().max()),
                       "median_ratio": float(ratio.median()),
                       "min_ratio": float(ratio.min())}
        if not ((q - 1).abs().max() <= 2e-3 and ratio.median() > 0.999
                and ratio.min() > 0.95):
            raise AssertionError(f"{key}: kernel fails the Rayleigh "
                                 f"contract {checks[key]}")
    for beta in (0.0, 1.0):
        got = mv.pmwf_solve(grs, grn, beta, return_powers=True)
        ref = mv.pmwf_solve_plain(grs, grn, beta, return_powers=True)
        key = f"pmwf_solve_beta{beta:g}"
        fam_errs[key] = max(_rel(g, r) for g, r in zip(got, ref))
        fam_abs[key] = max(_abs(g, r) for g, r in zip(got, ref))
        checks[key] = "plain within tol"
    # mpdr-whiten's steer: the whitened GEV vector, anchored to mic 0
    gsteer = fix_steer_phase((grn * mv.gevd_power_plain(
        grs, grn, power_iters=50)[..., None, :]).sum(-1)).contiguous()
    w_c = mv.capon(gsteer, gry)
    fam_errs["capon"] = _rel(w_c, mv.capon_plain(gsteer, gry))
    fam_abs["capon"] = _abs(w_c, mv.capon_plain(gsteer, gry))
    checks["capon"] = "plain within tol"
    torch.cuda.synchronize()
    print(json.dumps({"family_kernel_vs_plain_max_rel_err": fam_errs,
                      "checks": checks, "tol": TOL}))
    for key, err in fam_errs.items():
        if checks[key] == "plain within tol" and not err <= TOL:
            raise AssertionError(f"{key}: kernel vs plain {err} > {TOL}")

    # ---- 6. the family's path: BatchEnhancer over the gated scene ----
    swav16, smask, ssrc = _gated_scene(4, N, 48000, seed=2)
    gutts = {f"g{i:03d}": (gwav16[i], gmask[i], gsrc[i]) for i in range(B)}
    gutts.update({f"s{i}": (swav16[i], smask[i], ssrc[i]) for i in range(4)})
    fam_counted = (fm.stft_covar, mv.mvdr_power, mv.gevd_power,
                   mv.pmwf_solve, mv.capon, fm.beamform_istft)
    fam_launches, fam_worst, fam_corr = {}, {}, {}
    for (name, ban), solves in FAMILY:
        label = name + ("+ban" if ban else "")
        enhancer = BatchEnhancer(cfg, beamformer=name, batch_size=B,
                                 ban=ban, device="cuda")
        for fn in fam_counted:
            fn.launches = 0
        results = {}
        for key, (x, m, _) in gutts.items():
            results.update(enhancer.add(key, x, m))
        results.update(enhancer.flush())
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in fam_counted}
        fam_launches[label] = counts
        want = set(solves) | {"stft_covar", "beamform_istft"}
        if {k for k, c in counts.items() if c} != want:
            raise AssertionError(f"{label}: launched {counts}, needs {want}")
        if set(results) != set(gutts):
            raise AssertionError(f"{label}: BatchEnhancer lost utterances")
        worst, corr_min = 0.0, 1.0
        for bucket, keys in (
                (bucketer.bucket(S), [k for k in gutts if k[0] == "g"]),
                (bucketer.bucket(48000), [k for k in gutts if k[0] == "s"])):
            t_pad = cfg.num_frames(bucket)
            wv = np.zeros((len(keys), N, bucket), np.int16)
            mk = np.zeros((len(keys), t_pad, cfg.num_bins), np.float32)
            for i, key in enumerate(keys):
                x, m, _ = gutts[key]
                wv[i, :, :x.shape[-1]] = x
                mk[i, :m.shape[0]] = m[:t_pad]
            ref = enhance_plain(torch.from_numpy(wv).to(dev),
                                torch.from_numpy(mk).to(dev), cfg,
                                beamformer=name, ban=ban,
                                nsamps=bucket).cpu().numpy()
            for i, key in enumerate(keys):
                got, (x, _, c) = results[key], gutts[key]
                if got.shape != (x.shape[-1],) or not np.isfinite(got).all():
                    raise AssertionError(f"{label} {key}: bad output")
                r = ref[i, :x.shape[-1]]
                worst = max(worst,
                            float(np.abs(got - r).max() / np.abs(r).max()))
                corr_min = min(corr_min, float(np.corrcoef(got, c)[0, 1]))
        fam_worst[label], fam_corr[label] = worst, corr_min
        if not worst <= TOL:
            raise AssertionError(f"{label}: path vs plain {worst} > {TOL}")
        if label != "gevd" and not corr_min >= 0.9:
            raise AssertionError(f"{label}: correlation with the source at "
                                 f"mic 0 {corr_min} < 0.9")
    print(json.dumps({"family_path_launches": fam_launches}))
    print(json.dumps({"family_path_vs_plain_max_rel_err": fam_worst,
                      "min_corr_with_source_at_mic0": fam_corr, "tol": TOL,
                      "corr_bar": "0.9 for all but gevd (printed only)"}))

    # ---- 7. online MVDR: kernels, BatchEnhancer, streaming ----
    from setk_tpu_torch.enhance.pipeline import enhance_plain_online
    part_k = fm.stft_covar_chunks(wav_d, mask_d, window, CHUNK)
    part_p = fm.stft_covar_chunks_plain(wav_d, mask_d, window, CHUNK)
    es_k, en_k = fm.covar_ema(part_p, mask_d, CHUNK, ALPHA)
    es_p, en_p = fm.covar_ema_plain(part_p, mask_d, CHUNK, ALPHA)
    w_on = mv.mvdr_power(es_p, en_p)
    on_k = fm.beamform_istft_online(wav_d, w_on, wss_inv, window, CHUNK)
    on_p = fm.beamform_istft_online_plain(wav_d, w_on, wss_inv, window,
                                          CHUNK)
    torch.cuda.synchronize()
    on_errs = {"stft_covar_chunks": _rel(part_k, part_p),
               "covar_ema": max(_rel(es_k, es_p), _rel(en_k, en_p)),
               "beamform_istft_online": _rel(on_k, on_p)}
    on_abs = {"stft_covar_chunks": _abs(part_k, part_p),
              "covar_ema": max(_abs(es_k, es_p), _abs(en_k, en_p)),
              "beamform_istft_online": _abs(on_k, on_p)}
    print(json.dumps({"online_kernel_vs_plain_max_rel_err": on_errs,
                      "chunk": CHUNK, "alpha": ALPHA, "tol": TOL}))
    for name, err in on_errs.items():
        if not err <= TOL:
            raise AssertionError(f"{name}: kernel vs plain {err} > {TOL}")

    on_counted = (fm.stft_covar, fm.covar_ema, mv.mvdr_power,
                  fm.beamform_istft_online, fm.beamform_istft,
                  mv.gevd_power, mv.pmwf_solve, mv.capon)
    on_want = {"stft_covar", "covar_ema", "mvdr_power",
               "beamform_istft_online"}
    on_launches, on_worst, on_corr = {}, {}, {}
    for chunk, keys in ((CHUNK, list(utts)),
                        (24, [k for k in utts if k.startswith("x")])):
        enhancer = BatchEnhancer(cfg, batch_size=B, chunk_size=chunk,
                                 alpha=ALPHA, device="cuda")
        for fn in on_counted:
            fn.launches = 0
        results = {}
        for key in keys:
            x, m, _ = utts[key]
            results.update(enhancer.add(key, x, m))
        results.update(enhancer.flush())
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in on_counted}
        on_launches[chunk] = counts
        if {k for k, c in counts.items() if c} != on_want:
            raise AssertionError(f"online chunk {chunk}: launched {counts}, "
                                 f"needs exactly {sorted(on_want)}")
        if set(results) != set(keys):
            raise AssertionError("online BatchEnhancer lost utterances")
        buckets = {}
        for key in keys:
            buckets.setdefault(bucketer.bucket(utts[key][0].shape[-1]),
                               []).append(key)
        worst, corr_min, frames_on = 0.0, 1.0, []
        for bucket, bkeys in buckets.items():
            t_pad = cfg.num_frames(bucket)
            frames_on.append(t_pad)
            wv = np.zeros((len(bkeys), N, bucket), np.int16)
            mk = np.zeros((len(bkeys), t_pad, cfg.num_bins), np.float32)
            for i, key in enumerate(bkeys):
                x, m, _ = utts[key]
                wv[i, :, :x.shape[-1]] = x
                mk[i, :m.shape[0]] = m[:t_pad]
            ref = enhance_plain_online(
                torch.from_numpy(wv).to(dev), torch.from_numpy(mk).to(dev),
                cfg, chunk_size=chunk, alpha=ALPHA,
                nsamps=bucket).cpu().numpy()
            for i, key in enumerate(bkeys):
                got, (x, _, c) = results[key], utts[key]
                if got.shape != (x.shape[-1],) or not np.isfinite(got).all():
                    raise AssertionError(f"online {key}: bad output")
                r = ref[i, :x.shape[-1]]
                worst = max(worst,
                            float(np.abs(got - r).max() / np.abs(r).max()))
                corr_min = min(corr_min, float(np.corrcoef(got, c)[0, 1]))
        on_worst[chunk], on_corr[chunk] = worst, corr_min
        print(json.dumps({"online_chunk": chunk, "launches": counts,
                          "bucket_frames": sorted(frames_on),
                          "vs_plain_max_rel_err": worst,
                          "min_corr_with_clean": corr_min, "tol": TOL}))
        if not worst <= TOL:
            raise AssertionError(f"online chunk {chunk}: path vs plain "
                                 f"{worst} > {TOL}")
        if not corr_min >= 0.9:
            raise AssertionError(f"online chunk {chunk}: correlation with "
                                 f"the clean source {corr_min} < 0.9")

    # streaming: one 4 s utterance at a time, chunk 32 (the JAX package's
    # latency row, benchmarks/bench_latency.py:106-126)
    st_s = 4 * SR
    st_wav = wav_d[:1, :, :st_s].contiguous()
    st_mask = mask_d[:1, :cfg.num_frames(st_s)].contiguous()
    st_ref = enhance_plain_online(st_wav, st_mask, cfg, chunk_size=CHUNK,
                                  alpha=ALPHA)
    st_out = enhance_batch(st_wav, st_mask, cfg, chunk_size=CHUNK,
                           alpha=ALPHA)
    st_err = _rel(st_out, st_ref)
    if not st_err <= TOL:
        raise AssertionError(f"streaming vs plain {st_err} > {TOL}")
    st_ms = _time_ms(torch, lambda: enhance_batch(
        st_wav, st_mask, cfg, chunk_size=CHUNK, alpha=ALPHA))
    st_chunks = fm.num_chunks(cfg.num_frames(st_s), CHUNK)
    streaming = {"B": 1, "seconds": 4, "chunk": CHUNK, "chunks": st_chunks,
                 "ms_per_call": st_ms, "ms_per_chunk": st_ms / st_chunks,
                 "vs_plain_max_rel_err": st_err}
    print(json.dumps({"streaming": streaming}))

    # ---- 8. the CLI on the card against the CLI on the CPU ----
    from setk_tpu_torch.cli import apply_adaptive_beamformer as cli
    from setk_tpu_torch.io.wave import read_wav
    cli_worst = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        keys = _write_corpus(tmp, seed=3)
        for label, extra in (("offline", []),
                             ("online", ["--chunk-size", str(CHUNK)])):
            outs = {}
            for device in ("cuda", "cpu"):
                out_dir = tmp / f"{label}-{device}"
                cli.run(cli.make_parser().parse_args(
                    [str(tmp / "wav.scp"), str(tmp / "mask.scp"),
                     str(out_dir), "--batch-size", "4", "--device", device]
                    + extra))
                outs[device] = {}
                for key in keys:
                    path = out_dir / f"{key}.wav"
                    if not path.exists():
                        raise AssertionError(f"CLI {label} {device}: {key} "
                                             f"not written")
                    samps = read_wav(path, normalize=False)
                    if not np.isfinite(samps).all():
                        raise AssertionError(f"CLI {label}: {key} "
                                             f"not finite")
                    outs[device][key] = samps
            cli_worst[label] = max(
                float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max())
                for k in keys)
    print(json.dumps({"cli_card_vs_cpu_max_int16_steps": cli_worst,
                      "utterances": 6, "tol_steps": 2}))
    for label, worst in cli_worst.items():
        if not worst <= 2:
            raise AssertionError(f"CLI {label}: card vs CPU {worst} int16 "
                                 f"steps > 2")

    # ---- 9. timing at the bench shape ----
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
    bins = B * cfg.num_bins
    g_w = torch.empty((B, cfg.num_bins, N), dtype=torch.complex64, device=dev)
    rows += [
        ("gevd_power", "setk_tpu/ops/pallas/mvdr.py:474",
         lambda: mv.gevd_power(grs, grn, power_iters=30),
         lambda: mv.gevd_power_plain(grs, grn, power_iters=30),
         _bound(grs.nbytes + grn.nbytes + g_w.nbytes,
                _flops_gevd(bins, N, 30))),
        ("pmwf_solve", "setk_tpu/ops/pallas/mvdr.py:493",
         lambda: mv.pmwf_solve(grs, grn, 0.0, return_powers=True),
         lambda: mv.pmwf_solve_plain(grs, grn, 0.0, return_powers=True),
         _bound(2 * grs.nbytes + grn.nbytes + 2 * bins * N * 4,
                _flops_pmwf(bins, N))),
        ("capon", "setk_tpu/ops/pallas/mvdr.py:523",
         lambda: mv.capon(gsteer, gry),
         lambda: mv.capon_plain(gsteer, gry),
         _bound(gsteer.nbytes + gry.nbytes + g_w.nbytes,
                _flops_capon(bins, N))),
    ]
    n_chunks = fm.num_chunks(t_frames, CHUNK)
    rows += [
        ("stft_covar_chunks", "setk_tpu/ops/pallas/fused_mvdr.py:651",
         lambda: fm.stft_covar_chunks(wav_d, mask_d, window, CHUNK),
         lambda: fm.stft_covar_chunks_plain(wav_d, mask_d, window, CHUNK),
         _bound(wav_d.nbytes + mask_d.nbytes + part_k.nbytes,
                _flops_stft_covar(B, N, t_frames))),
        ("covar_ema", "setk_tpu/ops/pallas/fused_mvdr.py:651",
         lambda: fm.covar_ema(part_p, mask_d, CHUNK, ALPHA),
         lambda: fm.covar_ema_plain(part_p, mask_d, CHUNK, ALPHA),
         _bound(part_p.nbytes + mask_d.nbytes + es_k.nbytes + en_k.nbytes,
                _flops_covar_ema(B, N, t_frames, n_chunks))),
        ("beamform_istft_online", "setk_tpu/ops/pallas/fused_mvdr.py:771",
         lambda: fm.beamform_istft_online(wav_d, w_on, wss_inv, window,
                                          CHUNK),
         lambda: fm.beamform_istft_online_plain(wav_d, w_on, wss_inv,
                                                window, CHUNK),
         _bound(wav_d.nbytes + w_on.nbytes + wss_inv.nbytes + on_k.nbytes,
                _flops_beamform_istft(B, N, t_frames))),
    ]
    # the online path's launch counts (chunk 32 run of step 7); kernel A's
    # per-chunk launches count in stft_covar.launches
    launches.update(stft_covar_chunks=on_launches[CHUNK]["stft_covar"],
                    covar_ema=on_launches[CHUNK]["covar_ema"],
                    beamform_istft_online=on_launches[CHUNK][
                        "beamform_istft_online"])
    errs.update(on_errs)
    abs_errs.update(on_abs)
    source = {"stft_covar": "setk_tpu_torch/csrc/fused_mvdr.cu",
              "beamform_istft": "setk_tpu_torch/csrc/fused_mvdr.cu",
              "stft_covar_chunks": "setk_tpu_torch/csrc/fused_mvdr.cu",
              "covar_ema": "setk_tpu_torch/csrc/fused_mvdr.cu",
              "beamform_istft_online": "setk_tpu_torch/csrc/fused_mvdr.cu"}
    # the family's kernels: launches summed over the six runs of step 6
    launches.update({k: sum(c[k] for c in fam_launches.values())
                     for k in ("gevd_power", "pmwf_solve", "capon")})
    abs_errs.update(gevd_power=fam_abs["gevd_power_30"],
                    pmwf_solve=fam_abs["pmwf_solve_beta0"],
                    capon=fam_abs["capon"])
    errs.update(gevd_power=fam_errs["gevd_power_30"],
                pmwf_solve=fam_errs["pmwf_solve_beta0"],
                capon=fam_errs["capon"])
    # for information only: torch.linalg.solve on the same systems (the
    # port never calls it; it is not the same function, so library_ms
    # stays null)
    info = {"pmwf_solve": _time_ms(torch, lambda: torch.linalg.solve(grn,
                                                                      grs)),
            "capon": _time_ms(torch, lambda: torch.linalg.solve(
                gry, gsteer[..., None]))}
    kernels = []
    for name, replaces, run_k, run_p, (bound_ms, bound_by) in rows:
        eager_ms = _time_ms(torch, run_k)
        plain_ms = _time_ms(torch, run_p)
        row = {
            "name": name, "route": "cuda",
            "source": source.get(name, "setk_tpu_torch/csrc/mvdr_power.cu"),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": abs_errs[name], "max_rel_err": errs[name],
            "ms": _graph_ms(torch, run_k), "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
        if name in info:
            row["linalg_solve_ms_info"] = info[name]
        kernels.append(row)
    gevd50_ms = _graph_ms(torch, lambda: mv.gevd_power(grs, grn,
                                                       power_iters=50))
    step_ms = _time_ms(torch, lambda: enhance_batch(
        wav_d, mask_d, cfg, beamformer="mvdr"))
    plain_step_ms = _time_ms(torch, lambda: enhance_plain(
        wav_d, mask_d, cfg), iters=5, warmup=1)
    # the MVDR solve on the online batch of states (B x C x 257 bins)
    mvdr_online_ms = _graph_ms(torch, lambda: mv.mvdr_power(es_p, en_p))
    online_ms = _time_ms(torch, lambda: enhance_batch(
        wav_d, mask_d, cfg, chunk_size=CHUNK, alpha=ALPHA))
    online_plain_ms = _time_ms(torch, lambda: enhance_plain_online(
        wav_d, mask_d, cfg, chunk_size=CHUNK, alpha=ALPHA), iters=5,
        warmup=1)
    fam_ms = {}
    for (name, ban), _ in FAMILY:
        label = name + ("+ban" if ban else "")
        ms = _time_ms(torch, lambda: enhance_batch(
            gwav_d, gmask_d, cfg, beamformer=name, ban=ban))
        fam_ms[label] = {"ms": ms, "audio_s_per_s": B * SECS / (ms / 1e3)}
    print(json.dumps({
        "card": smi, "enhance_batch_ms": step_ms,
        "audio_s_per_s": B * SECS / (step_ms / 1e3),
        "plain_path_ms": plain_step_ms, "rfft_frames_ms_info": rfft_ms,
        "family_enhance_batch_gated_scene": fam_ms,
        "online_enhance_batch_ms": online_ms,
        "online_mvdr_power_ms": mvdr_online_ms,
        "online_audio_s_per_s": B * SECS / (online_ms / 1e3),
        "online_plain_path_ms": online_plain_ms, "streaming": streaming,
        "gevd_power_50_iters_ms": gevd50_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
