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
     then the same with --frame-len 1024 --frame-hop 512 (masks of that
     geometry), which takes the planar kernels on the card;
  9. P1, the planar geometry (n_fft 1024, hop 512, T = 251, F = 513) on
     the bench scene with a uniform mask: the planar STFT, the pair
     covariance with the complement mask and the planar iSTFT against
     their plain versions (1e-4 of the peak); enhance_batch and
     BatchEnhancer over step 4's keyed utterances (buckets T = 257, 225
     and 97) with exactly stft_planar, pair_covar_complement, mvdr_power
     and istft_planar launched, within 1e-4 of mvdr_enhance_planar_plain
     on the card and correlating >= 0.9 with the clean source; center
     off takes the port's inverse_stft instead of istft_planar;
  10. P2, an unaligned length (512/256, S = 128100, T = 501): the same
     kernel and enhance_batch checks, the last 100 samples zero (kernel
     10's tail); BatchEnhancer pads to hop-aligned buckets and takes the
     fused kernels;
  11. E, the spectrum-domain geometry (512/128, T = 1001, F = 257): the
     pair-covariance kernel against its plain version (complement and a
     random mask_n); mvdr+BAN on the bench scene and pmwf-0 on the gated
     scene through enhance_batch, launching exactly pair_covar and
     mvdr_power (mvdr) or pair_covar alone (pmwf-0), within 1e-4 of
     enhance_batch on the CPU copies of the inputs, correlation >= 0.9;
  12. refusals at the E geometry: gevd, mpdr and N = 9 raise
     NotImplementedError with no device memory allocated;
  13. times each kernel (20 launches replayed from one CUDA graph, so the
     wrapper's host work is not counted; the eager per-call time beside
     it), its plain version, the one PyTorch call that computes the same
     function where there is one (torch.stft, torch.istft, torch.einsum;
     never on the port's path), and enhance_batch for every name, for the
     online path and for P1, P2 and E with CUDA events (warm-up, then 20
     calls), profiles the fused, P1 and E steps (torch.profiler: device
     time by kernel, the device's idle share) and prints the kernels line;
  14. prints {"ok": true, "device": {...}} as the last line.
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
                      r"|covar_ema|beamform_istft_online|beamform_istft"
                      r"|istft_planar|stft_planar|pair_covar)"
                      r"_kernelILi(\d+)E(?:Lb([01])E)?([fs]?)E", line)
        if "Compiling entry function" in line and m:
            flag = {"0": ",0", "1": ",1"}.get(m.group(3), "")
            dtype = {"f": ",f32", "s": ",int16"}.get(m.group(4), "")
            key = f"{m.group(1)}<{m.group(2)}{flag}{dtype}>"
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


def _gated_scene(b, n, s, seed, cfg=None):
    """(wav int16 (B, N, S), mask (B, T, F), source at mic 0 (B, S)):
    a source at 0.2 in on/off bursts of 2048 samples, delayed one sample
    and attenuated 1/(1 + k/4) at mic k (nearest mic 0, so PMWF's
    SNR-selected reference is mic 0), noise at 0.05, and a 0.95/0.05 mask
    that follows the bursts per frame, as tests/test_pallas.py:413-424
    builds it; T and F of ``cfg``, by default the 512/256 STFT."""
    import numpy as np
    from setk_tpu_torch.dsp.stft import StftConfig
    cfg = cfg or StftConfig()
    rng = np.random.default_rng(seed)
    gate = (np.arange(s) // 2048) % 2 == 0
    src = (rng.standard_normal((b, s)) * 0.2 * gate).astype(np.float32)
    wav = rng.standard_normal((b, n, s)).astype(np.float32) * 0.05
    for k in range(n):
        wav[:, k] += np.roll(src, k, axis=-1) / (1 + k / 4)
    wav16 = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    t = cfg.num_frames(s)
    gate_f = gate[np.minimum(np.arange(t) * cfg.frame_hop, s - 1)]
    mask = np.ascontiguousarray(np.broadcast_to(
        np.where(gate_f, 0.95, 0.05)[None, :, None], (b, t, cfg.num_bins)),
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


def _write_corpus(root, seed, cfg=None):
    """Six 6-channel int16 wav files of 3-8 s (a clean source on every
    mic plus noise) with uniform [0, 1) masks of ``cfg``'s geometry (by
    default the 512/256 STFT) as .npy, and their scps."""
    import numpy as np
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.io.wave import write_wav
    cfg = cfg or StftConfig()
    root.mkdir(parents=True, exist_ok=True)
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


# ---- the planar and spectrum-domain geometries (kernels 9-12) ----
P1_FIELDS = {"frame_len": 1024, "frame_hop": 512}
P2_S = 128100                    # 8 s and 100 samples: off the hop grid
E_FIELDS = {"frame_len": 512, "frame_hop": 128}
PLANAR_SET = {"stft_planar", "pair_covar_complement", "mvdr_power",
              "istft_planar"}
FUSED_SET = {"stft_covar", "mvdr_power", "beamform_istft"}


def _fft_flops(n_fft):
    """One complex radix-2 FFT of n_fft points (10 FLOP a butterfly)."""
    return (n_fft // 2) * (n_fft.bit_length() - 1) * 10


def _flops_stft_planar(rows, t, n_fft):
    """Per frame: the window, half a complex FFT (two frames share one)
    and the Hermitian split of n_fft/2 + 1 bins."""
    return rows * t * (n_fft + _fft_flops(n_fft) / 2 + 4 * (n_fft // 2 + 1))


def _flops_istft_planar(b, t, n_fft):
    """Per frame: half a complex inverse FFT, the synthesis window, the
    1/n_fft scale, the overlap-add and the wss_inv multiply."""
    return b * t * (_fft_flops(n_fft) / 2 + 4 * n_fft)


def _flops_pair_covar(b, n, t, f, complement):
    """Per (frame, bin): the pair products (3 + 3 FLOP off the diagonal,
    3 on it) and the two masked sums (4 FLOP a complex entry, 2 on the
    diagonal); the complement mask costs 2 more."""
    per = 14 * n * (n - 1) // 2 + 7 * n + (2 if complement else 0)
    return b * t * f * per


def _all_counted():
    from setk_tpu_torch.ops.cuda import covariance_pair as cp
    from setk_tpu_torch.ops.cuda import fused_mvdr as fm
    from setk_tpu_torch.ops.cuda import mvdr as mv
    from setk_tpu_torch.ops.cuda import planar as pl
    return (fm.stft_covar, fm.beamform_istft, fm.covar_ema,
            fm.beamform_istft_online, mv.mvdr_power, mv.gevd_power,
            mv.pmwf_solve, mv.capon, pl.stft_planar, pl.istft_planar,
            cp.pair_covar_complement, cp.pair_covar)


def _launched(torch, run, label, want):
    """``run()`` with every kernel's launch count set to 0 just before and
    read just after; exactly the kernels in ``want`` must have launched.
    Returns run's result and the counts."""
    counted = _all_counted()
    for fn in counted:
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counted if fn.launches}
    if set(counts) != set(want):
        raise AssertionError(f"{label}: launched {counts}, needs exactly "
                             f"{sorted(want)}")
    return out, counts


def _pair_errs(torch, got, ref):
    """(relative, absolute) error of the Rs and Rn numerators given as
    four planes each."""
    rel, ab = 0.0, 0.0
    for k in (0, 2):
        g = torch.complex(got[k], got[k + 1])
        r = torch.complex(ref[k], ref[k + 1])
        rel, ab = max(rel, _rel(g, r)), max(ab, _abs(g, r))
    return rel, ab


def _min_corr(np, got, ref):
    """Smallest per-row correlation of two (B, S) arrays."""
    g = got - got.mean(-1, keepdims=True)
    r = ref - ref.mean(-1, keepdims=True)
    return float(((g * r).sum(-1) / np.sqrt((g * g).sum(-1) *
                                            (r * r).sum(-1))).min())


def _check_tol(what, errs):
    for name, err in errs.items():
        if not err <= TOL:
            raise AssertionError(f"{what} {name}: kernel vs plain {err} > "
                                 f"{TOL}")


def _planar_kernels(torch, dev, wav_d, mask_d, cfg):
    """Kernels 9, 11 and 10 against their plain versions on one batch
    (kernel 10 on mic 0's planes, the shape of a beamformed spectrum).
    Returns the relative and absolute errors and the tensors the timing
    reuses."""
    from setk_tpu_torch.ops.cuda import covariance_pair as cp
    from setk_tpu_torch.ops.cuda import planar as pl
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    s = wav_d.shape[-1]
    t = cfg.num_frames(s)
    fh = cfg.n_fft // 2
    planes = pl.stft_planar(wav_d, window, cfg.center)
    plain = pl.stft_planar_plain(wav_d, window, cfg.center)
    peak = float(torch.complex(plain[0], plain[1]).abs().max())
    err9 = max(_abs(k, p) for k, p in zip(planes, plain))
    msk = mask_d[..., :fh]
    nums = cp.pair_covar_complement(plain[0], plain[1], msk, t)
    err11 = _pair_errs(torch, nums, cp.pair_covar_complement_plain(
        plain[0], plain[1], msk, t))
    er, ei, ny = (x[:, 0].contiguous() for x in plain)
    wss = torch.as_tensor(pl.istft_wss_inverse(cfg.padded_window, t, s),
                          device=dev)
    out = pl.istft_planar(er, ei, ny, window, wss, s)
    out_p = pl.istft_planar_plain(er, ei, ny, window, wss, s)
    torch.cuda.synchronize()
    rel = {"stft_planar": err9 / peak, "pair_covar_complement": err11[0],
           "istft_planar": _rel(out, out_p)}
    ab = {"stft_planar": err9, "pair_covar_complement": err11[1],
          "istft_planar": _abs(out, out_p)}
    return rel, ab, {"window": window, "planes": plain, "mask": msk, "t": t,
                     "nums": nums, "er": er, "ei": ei, "ny": ny, "wss": wss,
                     "out": out}


def _by_bucket(np, torch, dev, cfg, utts, results, plain):
    """Each utterance's output against ``plain(wav, mask, nsamps=bucket)``
    run on the card bucket by bucket, as BatchEnhancer pads: (largest
    error relative to the peak, smallest correlation with the clean
    source, bucket frame counts)."""
    from setk_tpu_torch.parallel.executor import LengthBucketer
    bucketer = LengthBucketer(cfg)
    buckets = {}
    for key, (x, _, _) in utts.items():
        buckets.setdefault(bucketer.bucket(x.shape[-1]), []).append(key)
    worst, corr, frames = 0.0, 1.0, []
    for bucket, keys in buckets.items():
        t_pad = cfg.num_frames(bucket)
        frames.append(t_pad)
        n = utts[keys[0]][0].shape[0]
        wv = np.zeros((len(keys), n, bucket), np.int16)
        mk = np.zeros((len(keys), t_pad, cfg.num_bins), np.float32)
        for i, key in enumerate(keys):
            x, m, _ = utts[key]
            wv[i, :, :x.shape[-1]] = x
            mk[i, :m.shape[0]] = m[:t_pad]
        ref = plain(torch.from_numpy(wv).to(dev), torch.from_numpy(mk).to(dev),
                    cfg, nsamps=bucket).cpu().numpy()
        for i, key in enumerate(keys):
            got, (x, _, c) = results[key], utts[key]
            if got.shape != (x.shape[-1],) or not np.isfinite(got).all():
                raise AssertionError(f"{key}: bad output {got.shape}")
            r = ref[i, :x.shape[-1]]
            worst = max(worst, float(np.abs(got - r).max() / np.abs(r).max()))
            corr = min(corr, float(np.corrcoef(got, c)[0, 1]))
    return worst, corr, sorted(frames)


def _device_profile(torch, run, step_ms, iters=5, top=8):
    """torch.profiler over ``iters`` calls of ``run`` after a warm-up: ms
    a call of device time by kernel (the ``top`` largest) and their sum;
    the idle share is the part of the unprofiled step time ``step_ms``
    (CUDA events, free of the profiler's host overhead) with no kernel
    running."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    kernels = sorted(
        ((ev.self_device_time_total / 1e3 / iters, ev.key[:70])
         for ev in prof.key_averages()
         if ev.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    return {"step_ms": step_ms, "device_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / step_ms,
            "top": [[name, ms] for ms, name in kernels[:top]]}


def _run_enhancer(enhancer, utts):
    results = {}
    for key, (x, m, _) in utts.items():
        results.update(enhancer.add(key, x, m))
    results.update(enhancer.flush())
    return results


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
    from setk_tpu_torch.parallel.executor import BatchEnhancer

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
    enhancer = BatchEnhancer(cfg, batch_size=B, device="cuda")
    t0 = time.perf_counter()
    results, launches = _launched(
        torch, lambda: _run_enhancer(enhancer, utts), "main path", FUSED_SET)
    e2e_s = time.perf_counter() - t0
    print(json.dumps({"main_path_launches": launches,
                      "utterances": len(results), "seconds": e2e_s}))
    if set(results) != set(utts):
        raise AssertionError("BatchEnhancer lost utterances")
    # the plain path on the card, bucket by bucket as BatchEnhancer pads
    worst, corr, frames_seen = _by_bucket(np, torch, dev, cfg, utts, results,
                                          enhance_plain)
    print(json.dumps({"main_path_vs_plain_max_rel_err": worst,
                      "min_corr_with_clean": corr,
                      "bucket_frames": frames_seen, "tol": TOL}))
    if not worst <= TOL:
        raise AssertionError(f"main path vs plain {worst} > {TOL}")
    if not corr >= 0.9:
        raise AssertionError(f"main path: correlation with the clean source "
                             f"{corr} < 0.9")
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
    fam_launches, fam_worst, fam_corr = {}, {}, {}
    for (name, ban), solves in FAMILY:
        label = name + ("+ban" if ban else "")
        enhancer = BatchEnhancer(cfg, beamformer=name, batch_size=B,
                                 ban=ban, device="cuda")
        results, fam_launches[label] = _launched(
            torch, lambda: _run_enhancer(enhancer, gutts), label,
            set(solves) | {"stft_covar", "beamform_istft"})
        if set(results) != set(gutts):
            raise AssertionError(f"{label}: BatchEnhancer lost utterances")
        worst, corr_min, _ = _by_bucket(
            np, torch, dev, cfg, gutts, results,
            lambda w, m, c, nsamps: enhance_plain(w, m, c, beamformer=name,
                                                  ban=ban, nsamps=nsamps))
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

    on_want = {"stft_covar", "covar_ema", "mvdr_power",
               "beamform_istft_online"}
    on_launches, on_worst, on_corr = {}, {}, {}
    for chunk, keys in ((CHUNK, list(utts)),
                        (24, [k for k in utts if k.startswith("x")])):
        enhancer = BatchEnhancer(cfg, batch_size=B, chunk_size=chunk,
                                 alpha=ALPHA, device="cuda")
        sub = {key: utts[key] for key in keys}
        results, counts = _launched(
            torch, lambda: _run_enhancer(enhancer, sub),
            f"online chunk {chunk}", on_want)
        on_launches[chunk] = counts
        if set(results) != set(keys):
            raise AssertionError("online BatchEnhancer lost utterances")
        worst, corr_min, frames_on = _by_bucket(
            np, torch, dev, cfg, sub, results,
            lambda w, m, c, nsamps: enhance_plain_online(
                w, m, c, chunk_size=chunk, alpha=ALPHA, nsamps=nsamps))
        on_worst[chunk], on_corr[chunk] = worst, corr_min
        print(json.dumps({"online_chunk": chunk, "launches": counts,
                          "bucket_frames": frames_on,
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
    cli_worst, cli_launches = {}, {}
    cfg1 = StftConfig(**P1_FIELDS)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        keys = _write_corpus(tmp, seed=3)
        _write_corpus(tmp / "wide", seed=3, cfg=cfg1)
        for label, corpus, extra, want in (
                ("offline", tmp, [], FUSED_SET),
                ("online", tmp, ["--chunk-size", str(CHUNK)],
                 {"stft_covar", "covar_ema", "mvdr_power",
                  "beamform_istft_online"}),
                ("offline-1024/512", tmp / "wide",
                 ["--frame-len", "1024", "--frame-hop", "512"], PLANAR_SET)):
            outs = {}
            for device in ("cuda", "cpu"):
                out_dir = tmp / f"{label.replace('/', '-')}-{device}"
                argv = [str(corpus / "wav.scp"), str(corpus / "mask.scp"),
                        str(out_dir), "--batch-size", "4", "--device",
                        device] + extra
                if device == "cuda":
                    _, cli_launches[label] = _launched(
                        torch, lambda: cli.run(cli.make_parser().parse_args(
                            argv)), f"CLI {label}", want)
                else:
                    cli.run(cli.make_parser().parse_args(argv))
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
                      "cli_card_launches": cli_launches,
                      "utterances": 6, "tol_steps": 2}))
    for label, worst in cli_worst.items():
        if not worst <= 2:
            raise AssertionError(f"CLI {label}: card vs CPU {worst} int16 "
                                 f"steps > 2")

    # ---- 9. P1: the planar geometry, n_fft 1024, hop 512 ----
    from setk_tpu_torch.dsp.stft import forward_stft
    from setk_tpu_torch.enhance.pipeline import mvdr_enhance_planar_plain
    from setk_tpu_torch.ops.cuda import covariance_pair as cp
    from setk_tpu_torch.ops.cuda import planar as pl
    t1 = cfg1.num_frames(S)
    mask1 = rng.random((B, t1, cfg1.num_bins)).astype(np.float32)
    mask1_d = torch.from_numpy(mask1).to(dev)
    p1_errs, p1_abs, p1 = _planar_kernels(torch, dev, wav_d, mask1_d, cfg1)
    print(json.dumps({"P1_kernel_vs_plain_max_rel_err": p1_errs,
                      "T": t1, "F": cfg1.num_bins, "tol": TOL}))
    _check_tol("P1", p1_errs)
    out1, p1_launches = _launched(
        torch, lambda: enhance_batch(wav_d, mask1_d, cfg1), "P1 enhance_batch",
        PLANAR_SET)
    p1_err = _rel(out1, mvdr_enhance_planar_plain(wav_d, mask1_d, cfg1))
    p1_corr = _min_corr(np, out1.cpu().numpy(), clean)
    utts1 = {key: (x, rng.random((cfg1.num_frames(x.shape[-1]),
                                  cfg1.num_bins)).astype(np.float32), c)
             for key, (x, _, c) in utts.items()}
    enhancer = BatchEnhancer(cfg1, batch_size=B, device="cuda")
    res1, p1_be_launches = _launched(
        torch, lambda: _run_enhancer(enhancer, utts1), "P1 BatchEnhancer",
        PLANAR_SET)
    if set(res1) != set(utts1):
        raise AssertionError("P1 BatchEnhancer lost utterances")
    p1_be_err, p1_be_corr, p1_frames = _by_bucket(
        np, torch, dev, cfg1, utts1, res1, mvdr_enhance_planar_plain)
    # without center the planar path resynthesizes with dsp.inverse_stft
    cfg1n = StftConfig(**P1_FIELDS, center=False)
    mask1n_d = mask1_d[:8, :cfg1n.num_frames(S)].contiguous()
    out1n, _ = _launched(torch, lambda: enhance_batch(
        wav_d[:8], mask1n_d, cfg1n), "P1 center off",
        PLANAR_SET - {"istft_planar"})
    ref1n = mvdr_enhance_planar_plain(wav_d[:8], mask1n_d, cfg1n)
    if not torch.isfinite(out1n).all():
        raise AssertionError("P1 center off: non-finite output")
    # compared away from the two ends, where the window-sum-square
    # envelope vanishes and its guarded divide amplifies round-off
    # (ROADMAP queue 3)
    edge = cfg1n.n_fft
    p1n_err = _rel(out1n[:, edge:-edge], ref1n[:, edge:-edge])
    p1_path = {"enhance_batch": {"launches": p1_launches,
                                 "vs_plain_max_rel_err": p1_err,
                                 "min_corr_with_clean": p1_corr},
               "BatchEnhancer": {"launches": p1_be_launches,
                                 "bucket_frames": p1_frames,
                                 "vs_plain_max_rel_err": p1_be_err,
                                 "min_corr_with_clean": p1_be_corr},
               "center_off_B8_vs_plain_max_rel_err": p1n_err}
    print(json.dumps({"P1_path": p1_path, "tol": TOL}))
    for label, err in (("enhance_batch", p1_err),
                       ("BatchEnhancer", p1_be_err), ("center off", p1n_err)):
        if not err <= TOL:
            raise AssertionError(f"P1 {label}: path vs plain {err} > {TOL}")
    if not min(p1_corr, p1_be_corr) >= 0.9:
        raise AssertionError(f"P1: correlation with the clean source "
                             f"{min(p1_corr, p1_be_corr)} < 0.9")

    # ---- 10. P2: 512/256 at an unaligned length ----
    t2 = cfg.num_frames(P2_S)
    clean2 = rng.standard_normal((B, P2_S)).astype(np.float32) * 0.2
    wav2 = (clean2[:, None] +
            rng.standard_normal((B, N, P2_S)).astype(np.float32) * 0.05)
    wav2_16 = np.clip(wav2 * 32768.0, -32768, 32767).astype(np.int16)
    del wav2
    mask2 = rng.random((B, t2, cfg.num_bins)).astype(np.float32)
    wav2_d = torch.from_numpy(wav2_16).to(dev)
    mask2_d = torch.from_numpy(mask2).to(dev)
    p2_errs, p2_abs, _ = _planar_kernels(torch, dev, wav2_d, mask2_d, cfg)
    print(json.dumps({"P2_kernel_vs_plain_max_rel_err": p2_errs, "S": P2_S,
                      "T": t2, "tol": TOL}))
    _check_tol("P2", p2_errs)
    out2, p2_launches = _launched(
        torch, lambda: enhance_batch(wav2_d, mask2_d, cfg), "P2 enhance_batch",
        PLANAR_SET)
    p2_err = _rel(out2, mvdr_enhance_planar_plain(wav2_d, mask2_d, cfg))
    n_sig = (t2 - 1) * cfg.frame_hop
    if out2.shape != (B, P2_S) or out2[:, n_sig:].any():
        raise AssertionError(f"P2: {tuple(out2.shape)} output or a non-zero "
                             f"tail past sample {n_sig}")
    p2_corr = _min_corr(np, out2[:, :n_sig].cpu().numpy(), clean2[:, :n_sig])
    # BatchEnhancer pads to hop-aligned buckets: the fused kernels
    utts2 = {f"p{i:03d}": (wav2_16[i], mask2[i], clean2[i]) for i in range(B)}
    enhancer = BatchEnhancer(cfg, batch_size=B, device="cuda")
    res2, p2_be_launches = _launched(
        torch, lambda: _run_enhancer(enhancer, utts2), "P2 BatchEnhancer",
        FUSED_SET)
    p2_be_corr = min(float(np.corrcoef(res2[k], utts2[k][2])[0, 1])
                     for k in utts2)
    print(json.dumps({"P2_path": {
        "enhance_batch": {"launches": p2_launches,
                          "vs_plain_max_rel_err": p2_err,
                          "zero_tail_samples": P2_S - n_sig,
                          "min_corr_with_clean": p2_corr},
        "BatchEnhancer_fused_buckets": {"launches": p2_be_launches,
                                        "min_corr_with_clean": p2_be_corr}},
        "tol": TOL}))
    if not p2_err <= TOL:
        raise AssertionError(f"P2: path vs plain {p2_err} > {TOL}")
    if not min(p2_corr, p2_be_corr) >= 0.9:
        raise AssertionError(f"P2: correlation with the clean source "
                             f"{min(p2_corr, p2_be_corr)} < 0.9")

    # ---- 11. E: the spectrum-domain geometry, 512/128 ----
    cfg_e = StftConfig(**E_FIELDS)
    t_e = cfg_e.num_frames(S)
    mask_e = rng.random((B, t_e, cfg_e.num_bins)).astype(np.float32)
    mask_e_d = torch.from_numpy(mask_e).to(dev)
    spec_e = forward_stft(wav_d.float() / 32768.0, cfg_e)  # (B, N, T, F)
    mn_rand = torch.rand(mask_e_d.shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(5))
    mn_e = torch.clamp(1.0 - mask_e_d, min=0.0)
    nums_e = cp.pair_covar(spec_e, mask_e_d, mn_e)
    e_errs, e_abs = {}, {}
    for label, mn in (("complement", mn_e), ("random_mask_n", mn_rand)):
        e_errs[label], e_abs[label] = _pair_errs(
            torch, cp.pair_covar(spec_e, mask_e_d, mn),
            cp.pair_covar_plain(spec_e, mask_e_d, mn))
    print(json.dumps({"E_pair_covar_vs_plain_max_rel_err": e_errs, "T": t_e,
                      "F": cfg_e.num_bins, "tol": TOL}))
    _check_tol("E pair_covar", e_errs)
    gwav_e16, gmask_e, gsrc_e = _gated_scene(B, N, S, seed=1, cfg=cfg_e)
    gwav_e_d = torch.from_numpy(gwav_e16).to(dev)
    gmask_e_d = torch.from_numpy(gmask_e).to(dev)
    e_path = {}
    for label, (w16, w_d, mk, mk_d, src), kw, want in (
            ("mvdr+ban", (wav16, wav_d, mask_e, mask_e_d, clean),
             {"ban": True}, {"pair_covar", "mvdr_power"}),
            ("pmwf-0", (gwav_e16, gwav_e_d, gmask_e, gmask_e_d, gsrc_e),
             {"beamformer": "pmwf-0"}, {"pair_covar"})):
        out_e, counts = _launched(torch, lambda: enhance_batch(
            w_d, mk_d, cfg_e, **kw), f"E {label}", want)
        ref_e = enhance_batch(w16, mk, cfg_e, steer="power", device="cpu",
                              **kw).numpy()
        got_e = out_e.cpu().numpy()
        err = float(np.abs(got_e - ref_e).max() / np.abs(ref_e).max())
        e_path[label] = {"launches": counts, "vs_cpu_max_rel_err": err,
                         "min_corr_with_source": _min_corr(np, got_e, src)}
    print(json.dumps({"E_path": e_path, "tol": TOL}))
    for label, row in e_path.items():
        if not row["vs_cpu_max_rel_err"] <= TOL:
            raise AssertionError(f"E {label}: card vs CPU "
                                 f"{row['vs_cpu_max_rel_err']} > {TOL}")
        if not row["min_corr_with_source"] >= 0.9:
            raise AssertionError(f"E {label}: correlation "
                                 f"{row['min_corr_with_source']} < 0.9")

    # ---- 12. refusals before any device allocation ----
    refused = {}
    wav9 = np.zeros((2, 9, S), np.int16)
    before = torch.cuda.memory_allocated()
    for label, w, kw in (("gevd", wav16[:2], {"beamformer": "gevd"}),
                         ("mpdr", wav16[:2], {"beamformer": "mpdr"}),
                         ("N=9", wav9, {})):
        try:
            enhance_batch(w, mask_e[:2], cfg_e, **kw)
        except NotImplementedError as exc:
            refused[label] = re.search(r"ROADMAP [^;,]*", str(exc)).group(0)
        else:
            raise AssertionError(f"E {label} was not refused")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("a refusal allocated device memory")
    print(json.dumps({"E_refusals": refused}))

    # ---- 13. timing at the bench shape ----
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
    launches.update({k: sum(c.get(k, 0) for c in fam_launches.values())
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
    # the planar and spectrum-domain kernels at P1 (9-11) and E (12)
    fh1 = cfg1.n_fft // 2
    re1, im1 = p1["planes"][0], p1["planes"][1]
    rows += [
        ("stft_planar", "setk_tpu/ops/pallas/stft.py:126",
         lambda: pl.stft_planar(wav_d, p1["window"], True),
         lambda: pl.stft_planar_plain(wav_d, p1["window"], True),
         _bound(wav_d.nbytes + sum(x.nbytes for x in p1["planes"]),
                _flops_stft_planar(B * N, t1, cfg1.n_fft))),
        ("pair_covar_complement", "setk_tpu/ops/pallas/covariance_pair.py:105",
         lambda: cp.pair_covar_complement(re1, im1, p1["mask"], t1),
         lambda: cp.pair_covar_complement_plain(re1, im1, p1["mask"], t1),
         _bound(re1.nbytes + im1.nbytes + B * t1 * fh1 * 4 +
                sum(x.nbytes for x in p1["nums"]),
                _flops_pair_covar(B, N, t1, fh1, True))),
        ("istft_planar", "setk_tpu/ops/pallas/stft.py:300",
         lambda: pl.istft_planar(p1["er"], p1["ei"], p1["ny"], p1["window"],
                                 p1["wss"], S),
         lambda: pl.istft_planar_plain(p1["er"], p1["ei"], p1["ny"],
                                       p1["window"], p1["wss"], S),
         _bound(p1["er"].nbytes + p1["ei"].nbytes + p1["ny"].nbytes +
                p1["wss"].nbytes + p1["out"].nbytes,
                _flops_istft_planar(B, t1, cfg1.n_fft))),
        ("pair_covar", "setk_tpu/ops/pallas/covariance_pair.py:139",
         lambda: cp.pair_covar(spec_e, mask_e_d, mn_e),
         lambda: cp.pair_covar_plain(spec_e, mask_e_d, mn_e),
         _bound(spec_e.nbytes + mask_e_d.nbytes + mn_e.nbytes +
                sum(x.nbytes for x in nums_e),
                _flops_pair_covar(B, N, t_e, cfg_e.num_bins, False))),
    ]
    launches.update(stft_planar=p1_be_launches["stft_planar"],
                    pair_covar_complement=p1_be_launches[
                        "pair_covar_complement"],
                    istft_planar=p1_be_launches["istft_planar"],
                    pair_covar=e_path["mvdr+ban"]["launches"]["pair_covar"])
    errs.update(p1_errs, pair_covar=e_errs["random_mask_n"])
    abs_errs.update(p1_abs, pair_covar=e_abs["random_mask_n"])
    source.update(stft_planar="setk_tpu_torch/csrc/planar_stft.cu",
                  istft_planar="setk_tpu_torch/csrc/planar_stft.cu",
                  pair_covar_complement="setk_tpu_torch/csrc/"
                                        "covariance_pair.cu",
                  pair_covar="setk_tpu_torch/csrc/covariance_pair.cu")
    # the one PyTorch call that computes each function, timed for
    # comparison only (the port never calls these)
    wav_rows = (wav_d.float() / 32768.0).reshape(B * N, S)
    spec1 = torch.complex(torch.cat([p1["er"], p1["ny"][..., None]], -1),
                          torch.cat([p1["ei"], torch.zeros_like(
                              p1["ny"][..., None])], -1)).transpose(1, 2)
    obs1 = torch.complex(re1, im1)
    masks1 = torch.stack([p1["mask"], torch.clamp(1 - p1["mask"], min=0)])
    masks_e = torch.stack([mask_e_d, mn_e])
    library = {
        "stft_planar": _time_ms(torch, lambda: torch.stft(
            wav_rows, cfg1.n_fft, cfg1.frame_hop, window=p1["window"],
            center=True, pad_mode="reflect", return_complex=True)),
        "istft_planar": _time_ms(torch, lambda: torch.istft(
            spec1, cfg1.n_fft, cfg1.frame_hop, window=p1["window"],
            center=True, length=S)),
        "pair_covar_complement": _time_ms(torch, lambda: torch.einsum(
            "bntf,bmtf,kbtf->kbnmf", obs1, obs1.conj(), masks1), iters=5),
        "pair_covar": _time_ms(torch, lambda: torch.einsum(
            "bntf,bmtf,kbtf->kbnmf", spec_e, spec_e.conj(), masks_e),
            iters=5),
    }
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
            "bound_by": bound_by, "library_ms": library.get(name)}
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
    geo_ms = {}
    for label, run, secs in (
            ("P1_1024_512", lambda: enhance_batch(wav_d, mask1_d, cfg1), SECS),
            ("P2_512_256_S128100", lambda: enhance_batch(wav2_d, mask2_d, cfg),
             P2_S / SR),
            ("E_512_128_mvdr", lambda: enhance_batch(wav_d, mask_e_d, cfg_e),
             SECS),
            ("E_512_128_mvdr+ban", lambda: enhance_batch(
                wav_d, mask_e_d, cfg_e, ban=True), SECS),
            ("E_512_128_pmwf-0", lambda: enhance_batch(
                gwav_e_d, gmask_e_d, cfg_e, beamformer="pmwf-0"), SECS)):
        ms = _time_ms(torch, run)
        geo_ms[label] = {"ms": ms, "audio_s_per_s": B * secs / (ms / 1e3)}
    geo_ms["P1_plain_ms"] = _time_ms(torch, lambda: mvdr_enhance_planar_plain(
        wav_d, mask1_d, cfg1), iters=5, warmup=1)
    # where a step's device time goes, and how long the card waits
    profiles = {
        "mvdr_512_256_fused": _device_profile(torch, lambda: enhance_batch(
            wav_d, mask_d, cfg), step_ms),
        "P1_1024_512": _device_profile(torch, lambda: enhance_batch(
            wav_d, mask1_d, cfg1), geo_ms["P1_1024_512"]["ms"]),
        "E_512_128_mvdr+ban": _device_profile(torch, lambda: enhance_batch(
            wav_d, mask_e_d, cfg_e, ban=True),
            geo_ms["E_512_128_mvdr+ban"]["ms"]),
        "E_512_128_pmwf-0": _device_profile(torch, lambda: enhance_batch(
            gwav_e_d, gmask_e_d, cfg_e, beamformer="pmwf-0"),
            geo_ms["E_512_128_pmwf-0"]["ms"])}
    print(json.dumps({"device_profiles": profiles}))
    print(json.dumps({
        "card": smi, "enhance_batch_ms": step_ms,
        "planar_and_spectrum_steps": geo_ms,
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
