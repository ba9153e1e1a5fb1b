#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and
the CUDA toolkit.  In order it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernels from setk_tpu_torch/csrc (one nvcc per source,
     all at once) and prints the build time and ptxas' register and
     spill counts (kernels 9's and 10's instances at every n_fft on lines
     of their own);
  3. holds kernel A, the MVDR solve and kernel B against their plain
     PyTorch versions on the card at the bench shape (B=128, N=6, 8 s at
     16 kHz, int16 audio, mask uniform on [0, 1) from
     numpy.random.default_rng(0)): max |diff| / max |plain| <= 1e-4;
     kernel A also at N = 1, 2, 5 and 8, int16 and f32 (an f32 waveform
     off 16-byte alignment), many runs an utterance, S = 512, and per
     chunk at chunks 1, 5 and 64; prints kernel A's registers and spills
     at N = 6 and 8 (step 2) and its layout; kernel B, offline and online,
     also at N = 1, 2, 5, 6 and 8, int16 and unaligned f32, B = 1 at
     S = 512, many runs an utterance and chunks 1, 3, 5 and 32, with its
     registers, spills and layout (step 2);
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
     covariance with the complement mask and the planar iSTFT (kernel
     10's two entries: on mic 0's planes, and beamforming every mic's
     planes with seeded random weights) against their plain versions
     (1e-4 of the peak); enhance_batch and BatchEnhancer over step 4's
     keyed utterances (buckets T = 257, 225 and 97) with exactly
     stft_planar, pair_covar_complement, mvdr_power and
     beamform_istft_planar launched, within 1e-4 of
     mvdr_enhance_planar_plain on the card and correlating >= 0.9 with
     the clean source; center off takes a beamform pass and the port's
     inverse_stft instead of beamform_istft_planar;
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
  12. refusals at the E geometry: N = 9 (mvdr and gevd) raises
     NotImplementedError with no device memory allocated;
  13. C1, CGMM/CACGMM mask estimation on the gated scene's STFT (B=128,
     6 mics, 512/256, T = 501 padded to BatchClusterer's 512-frame
     bucket, a frame mask): the masked covariance (kernel 13) on the
     scan's K=2 weights and the Jacobi inverse (kernel 14) on those
     covariances against their plain versions (1e-4 of the peak, of each
     matrix's peak for kernel 14); the fused EM (kernel 15) against its
     plain version at 4 iterations for cgmm with the Higuchi init,
     cacgmm from one generator-drawn gamma, cacgmm with the Higuchi init,
     K=3 cacgmm at B=16, cgmm at WPD's shape (B = 32, the first 251
     frames, no frame mask) and cacgmm at M = 8, K = 4, B = 4 (each
     utterance's mics and two of the next one's) (tests/test_pallas.py's
     bars: gamma 2e-3, Q rtol 2e-3 + atol 1e-3, alpha 2e-3, covariances
     2e-2 of the peak); prints em_warp<6,2>'s registers, stack and
     spills from step 2;
  14. C2, BatchClusterer(device="cuda", batch_size=128) for cgmm and
     cacgmm over the 128 utterances and four shorter ones (buckets of
     512, 384 and 256 frames), counts reset before and read after: exactly
     kernel 15 launched; masks finite, in [0, 1], summing to 1 over K; at
     20 iterations against the plain path on the card bucket by bucket,
     mask correlation >= 0.9999 and the 512 bucket's Q history within
     rtol 2e-3;
  15. C3, the clustering CLIs on the card against --device cpu over step
     8's corpus: estimate_cgmm_masks --batch-size 4 (kernel 15 alone,
     masks within 2e-3), the per-utterance path with --dump-model, then
     --resume-model (exactly kernels 13 and 14: iterations and
     iterations + 1 launches an utterance), and the recipe's chain, the
     card's masks into apply_adaptive_beamformer --batch-size 4 on the
     card, every key written and finite;
  16. C4, refusals: M = 9 and num_iters = 0 raise with no device memory
     allocated;
  17. WPE and WPD at the JAX package's bench width (B = 32, 6 mics, 8 s,
     512/256, taps 10, delay 3, context 1, 3 iterations; WPD 4 s, 3 outer,
     CGMM 10): W1 holds kernels 16-19 against their plain versions on a
     noise scene (noise at 0.2, bench_secondary.py:123-127) and a
     reverberant one (TOL of the peak for the Gram and the application,
     2e-3 of the peak for the solves of the scenes' Grams, 5e-3 of the
     peak equilibrated), kernel 17 at NK = 9, 30 and 60 with and without
     equilibration, kernel 16 at n = 60 and n = 128 (8 mics, taps 16:
     dynamic shared memory), and both on the CPU tests' systems
     (tests/test_pallas.py:793's Grams, rtol 1e-3 + atol 1e-4);
     W2 runs wpe fused on both scenes (exactly 18 x3, 17 x3, 19 x1; the
     noise scene within 2e-3 of the same loop through the plain versions,
     the reverberant one, whose tap correlations are ill conditioned,
     within 2e-2 of the peak of a float64 run of the plain loop and the
     median utterance within 2e-3 of its peak), the scan
     (exactly 16 x3) and a chirp input (finite); W3 runs BatchWpe over 32
     keyed 8 s utterances and four other lengths (one 30 s, one that
     fills its bucket) of the noise scene (exact launch counts, finite;
     the unpadded output within 2e-3 of the plain path's peak; padded
     frames make the solves badly conditioned, so padded outputs within
     7e-2 of their peak of a float64 run of the plain path), then over the
     reverberant scene, recording how many padded outputs are not finite
     on each path (lambda = EPSILON on zero padding, the JAX package's
     semantics); W4 runs apply_wpe (--batch-size 4 and 1) and apply_wpd on
     the card against --device cpu (files written on both correlate >=
     0.99, WPD masks too; utterances that no bucket pads must be
     written); W5 runs
     wpd at B = 32 x 4 s on the noise scene (exactly 18, 17, 19, 15, 12
     and 2 three times each; cosine and mask correlation >= 0.995 against
     the same call through the plain versions, chained CGMM being
     chaotic) and on the reverberant one (recorded, finite); N = 9 is
     refused with no allocation;
  18. the BLSTM mask estimator at the train CLI's width (MaskNet blstm,
     257 bins, hidden 512, 3 layers) and the JAX training bench's batch
     (B = 64, T = 400): N1 holds both variants of kernels 20 and 21
     (resident and stream, each through its own entry point) against their
     plain versions (f32 and bf16 weights at the full shape, B = 1 and B =
     6, a ragged tile of 4 rows; 1e-5 of the peak f32, 2e-3 bf16), checks
     that both gates pick the resident variants at each of those shapes,
     and
     holds the gradients through lstm_seq_bidir against autograd through
     the plain forward (2e-4 f32, 1e-2 bf16, where kernel 21 rounds dgates
     and autograd rounds the products); N2 runs MaskNet's forward (exactly
     kernel 20's resident variant, 3 times) against the same call through
     the plain versions (1e-4); N3 runs 5 MaskTrainer steps with a frame
     mask (exactly 3 x kernel 20 resident and 3 x kernel 21 resident a
     step, losses finite and within 1e-5 of the plain path from the same
     init); N4 runs
     the recipe's chain
     (recipes/train_mask.sh:22-27) on 8 utterances: compute_mask on the
     card and with --device cpu, train_mask_estimator --arch blstm on the
     card (2 epochs, exact launch counts), estimate_nn_masks from its
     checkpoint on both devices (targets 2e-6, masks 2e-4); it times
     kernels 20-21 (bf16, graph replay, eager, plain, each one's stream
     variant, cuDNN's nn.LSTM for information: forward, forward and
     backward, backward alone), the resident variants' per-step floor (H =
     8, B = 1) and B = 1 at H = 512, and the serving (B = 64 and B = 1) and
     training steps with their profiles;
  19. V1-V3, the batched Hermitian EVD kernel (csrc/eigh_small.cu
     hermitian_eigh_kernel, a thread a matrix, and
     hermitian_eigh_lanes_kernel, a lane group a matrix; it replaces
     XLA's eigh) and what it brings: V1 holds each form built at M
     (eigh_forms: a thread at M <= 3 and 5-7, lanes at M >= 4) against the plain
     version at M = 1-8, plain and generalized, at 257, 4,112 and 32,896
     matrices (one utterance's bins, 8 s at chunk 32, B = 128): the gated
     scene's Rs/Rn at M = 6, else a quarter rank one plus noise and the
     rest full rank, one all-zero matrix each (eigenvalues within 1e-4 of
     each matrix's peak; principal vectors, where the top eigenvalue
     stands 1e-3 of the peak above the next, within 1 - 1e-5 in |cos|),
     and times both forms and the launcher's pick at M = 6 (graph replay,
     eager, plain) beside the bound recounted from the sweeps the
     matrices take (eigh_sweeps_needed: mean and largest) and
     torch.linalg.eigh at the counts it takes; V2 runs the per-utterance CLI (no --batch-size) on
     the card and with --device cpu over 4 gated-scene utterances of 6 ch
     x 8 s for mvdr, gevd+BAN, mpdr, mpdr-whiten, pmwf-0 with the GEV
     rank-1 approximation and --pmwf-ref 0, pmwf-1 with --itf-mask, mvdr
     with --vad-proportion 0.9 --mask true, and online gevd and mvdr at
     --chunk-size 32: exact launches an utterance, files within 2 int16
     steps, seconds an utterance; V3 drives the batch paths the kernel
     lifted, each against its plain path: enhance_batch with the eigh
     steer in the fused geometry against enhance_plain(steer="eigh") on
     the card, gevd at 1024/512 and online gevd at chunk 32 against
     enhance_batch on the CPU copies (1e-4 of the peak), and the WPD scan
     at N taps = 132 against wpd on the CPU (cosine and mask correlation
     >= 0.995, W5's bar), with exact launch sets;
  20. times each kernel (20 launches replayed from one CUDA graph, so the
     wrapper's host work is not counted; the eager per-call time beside
     it), its plain version, the one PyTorch call that computes the same
     function where there is one (torch.stft, torch.istft, torch.einsum,
     torch.linalg.solve of kernels 16-17's loaded systems, kernel 19's
     grouped complex conv1d; never on the port's path), and enhance_batch
     for every name, for the
     online path and for P1, P2 and E, and the cgmm/cacgmm EM at B=128
     with CUDA events (warm-up, then 20 calls; fewer for the slow plain
     versions and the EM; kernel 15 also at WPD's shape, kernel 9 also at
     P2, kernel 14 also at the CGMM CLI resume's launch of one
     utterance's 2 x 257 matrices, held to its plain version there),
     profiles the fused, P1, E and EM steps
     (torch.profiler: device time by kernel, the device's idle share)
     and prints the kernels line (kernels 16-19 timed at W's scene, with
     the wpe, wpd and BatchWpe steps and their idle shares, 20-21 and the
     BLSTM steps from step 18);
  21. prints {"ok": true, "device": {...}} as the last line.
Any failure raises and exits non-zero.  Without a CUDA device, or
without the setk_tpu_torch package beside this file, it exits 2, says
which on stdout and stderr, and prints no result.
"""

import ctypes
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
# setk_tpu_torch/csrc): kernels A and B's radix-8 transform is 3 passes x
# 64 8-point DFTs x 56 FLOP (52 additions, 4 multiplications) and the
# twiddles that are not 1 (49 x 8 of W64^(b k0) after the first pass,
# 7 x 63 of W512^(c (k0 + 8 k1)) after the second) at 6 FLOP; each
# forward transform carries two mics, each inverse two frames.
FFT512_RADIX8_FLOP = 3 * 64 * 56 + 6 * (49 * 8 + 7 * 63)


def _flops_stft_covar(b, n, t):
    pairs = (n + 1) // 2
    per_frame = n * 512 + pairs * FFT512_RADIX8_FLOP + 257 * (
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


def _tri_flops(n):
    # one triangular substitution or product: complex multiply-subtracts
    # and the pivots' scalings
    return 4 * n * (n - 1) + 2 * n


def _flops_gevd(bins, n, iters):
    """The whitened power iteration of csrc/mvdr_power.cu: the Cholesky,
    D Rs D and M = L^{-1} (D Rs D) L^{-H} (2N substitutions), w = L^H
    D^{-1} ramp; an iteration a Hermitian matvec and a norm; then one back
    substitution, D and the unit norm, v^H Rn v, the scale and the
    anchor."""
    setup = _chol_flops(n) + 4 * n * n + 2 * n * _tri_flops(n) + _tri_flops(n)
    per_iter = 8 * n * n + 6 * n
    tail = _tri_flops(n) + 8 * n + 8 * n * n + 12 * n
    return bins * (setup + iters * per_iter + tail)


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
    fwd = n * 512 + pairs * FFT512_RADIX8_FLOP + 257 * (pairs * 8 + n * 8)
    inv = FFT512_RADIX8_FLOP / 2 + 512 * 3
    return b * t * (fwd + inv)


def _card_wav(np, torch, dev, rng, b, n, s, int16):
    """(B, N, S) noise at 0.3 on the card: int16, or f32 4 bytes past a
    16-byte boundary (the kernels' sample-by-sample staging)."""
    x = rng.standard_normal((b, n, s)).astype(np.float32) * 0.3
    if int16:
        x = np.clip(x * 32768, -32768, 32767).astype(np.int16)
    flat = x.ravel()
    if not int16:
        flat = np.concatenate([np.zeros(1, flat.dtype), flat])
    return torch.from_numpy(flat).to(dev)[flat.size - x.size:].view(b, n, s)


def _kernel_a_shapes(np, torch, dev, window, fm):
    """Kernel A away from the bench shape, against its plain version: N =
    1, 2, 5 and 8, int16 and f32 (an f32 waveform not 16-byte aligned),
    B = 4 (many runs an utterance) and B = 1 at S = 512, and per chunk at
    chunks 1, 5 and 64; raises past TOL, returns the errors."""
    errs = {}
    for n, s, int16, chunk in ((1, 39936, True, None), (2, 512, False, None),
                               (5, 64000, True, 5), (8, 128000, True, None),
                               (8, 40960, False, 1), (5, 20480, False, None),
                               (2, 4096, True, 64)):
        rng = np.random.default_rng(n + s)
        b = 1 if s == 512 else 4
        wav = _card_wav(np, torch, dev, rng, b, n, s, int16)
        mask = torch.from_numpy(rng.random((b, s // 256 + 1, 257)).astype(
            np.float32)).to(dev)
        if chunk is None:
            got = torch.cat(fm.stft_covar(wav, mask, window), -1)
            ref = torch.cat(fm.stft_covar_plain(wav, mask, window), -1)
        else:
            got = fm.stft_covar_chunks(wav, mask, window, chunk)
            ref = fm.stft_covar_chunks_plain(wav, mask, window, chunk)
        key = (f"N{n}_S{s}_{'int16' if int16 else 'f32_unaligned'}"
               f"_{'offline' if chunk is None else f'chunk{chunk}'}")
        errs[key] = _rel(got, ref)
        if not errs[key] <= TOL:
            raise AssertionError(f"kernel A {key}: {errs[key]} > {TOL}")
    return errs


def _kernel_b_shapes(np, torch, dev, window, fm):
    """Kernel B away from the bench shape, against its plain version:
    offline and online, N = 1, 2, 5, 6 and 8, int16 and f32 (an f32
    waveform not 16-byte aligned), B = 1 at S = 512, B = 4 (many runs an
    utterance) and online at chunks 1, 3, 5 (chunks that do not divide the
    tile of 8 frames) and 32; raises past TOL, returns the errors."""
    from setk_tpu_torch.dsp.window import wss_inverse_blocks
    errs = {}
    for n, s, int16, chunk in ((1, 39936, True, None), (2, 512, False, None),
                               (5, 64000, True, None), (8, 128000, True, None),
                               (8, 40960, False, None), (5, 20480, False, 5),
                               (8, 64000, True, 1), (2, 4096, False, 3),
                               (6, 128000, True, 32), (1, 512, True, 1)):
        rng = np.random.default_rng(n + s + 7)
        b = 1 if s == 512 else 4
        t = s // 256 + 1
        wav = _card_wav(np, torch, dev, rng, b, n, s, int16)
        shape = (b, 257, n) if chunk is None else (
            b, fm.num_chunks(t, chunk), 257, n)
        w = torch.from_numpy((rng.standard_normal(shape) + 1j *
                              rng.standard_normal(shape)).astype(
                                  np.complex64)).to(dev)
        wss = torch.as_tensor(wss_inverse_blocks(
            window.cpu().numpy(), t, 256, 512, s), device=dev)
        if chunk is None:
            got = fm.beamform_istft(wav, w, wss, window)
            ref = fm.beamform_istft_plain(wav, w, wss, window)
        else:
            got = fm.beamform_istft_online(wav, w, wss, window, chunk)
            ref = fm.beamform_istft_online_plain(wav, w, wss, window, chunk)
        key = (f"N{n}_S{s}_B{b}_{'int16' if int16 else 'f32_unaligned'}"
               f"_{'offline' if chunk is None else f'chunk{chunk}'}")
        errs[key] = _rel(got, ref)
        if not errs[key] <= TOL:
            raise AssertionError(f"kernel B {key}: {errs[key]} > {TOL}")
    return errs


def _ptxas_summary(log: str) -> dict:
    """Registers, spills and shared memory per kernel instance from
    nvcc's -Xptxas -v log, keyed like "stft_covar<6,int16>"."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(mvdr_power|gevd_power|pmwf_solve|capon|stft_covar"
                      r"|covar_ema|beamform_istft_online|beamform_istft"
                      r"|istft_planar|stft_planar|pair_covar|masked_covar"
                      r"|regularized_inverse|hermitian_eigh_lanes|hermitian_eigh"
                      r"|hermitian_solve"
                      r"|gram_solve"
                      r"|wpe_gram|wpe_apply|em_warp|warp_jacobi)"
                      r"_kernelILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?([fs]?)E",
                      line)
        if "Compiling entry function" in line and m:
            classes = f",{m.group(3)}" if m.group(3) else ""
            flag = {"0": ",0", "1": ",1"}.get(m.group(4), "")
            dtype = {"f": ",f32", "s": ",int16"}.get(m.group(5), "")
            key = f"{m.group(1)}<{m.group(2)}{classes}{flag}{dtype}>"
            out[key] = {}
        lstm = re.search(r"\d(lstm_[a-z_]+?)_kernelINS_\d+(F32|BF16)E",
                         line)
        if "Compiling entry function" in line and lstm:
            key = f"{lstm.group(1)}<{lstm.group(2).lower()}>"
            out[key] = {}
        elif key and "spill stores" in line:
            out[key]["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", line))
            out[key]["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line).group(1))
            out[key]["stack_bytes"] = int(
                re.search(r"(\d+) bytes stack frame", line).group(1))
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


def _write_corpus(root, seed, cfg=None, lengths=None, prefix="c"):
    """Six 6-channel int16 wav files of 3-8 s (or of ``lengths`` samples;
    a clean source on every mic plus noise) with uniform [0, 1) masks of
    ``cfg``'s geometry (by default the 512/256 STFT) as .npy, and their
    scps; keys ``prefix`` + index."""
    import numpy as np
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.io.wave import write_wav
    cfg = cfg or StftConfig()
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    wav_lines, mask_lines = [], []
    lengths = lengths or [secs * SR + 37 * i
                          for i, secs in enumerate((3, 4, 5, 6, 7, 8))]
    for i, s in enumerate(lengths):
        clean = rng.standard_normal(s).astype(np.float32) * 0.2
        x = clean + rng.standard_normal((N, s)).astype(np.float32) * 0.05
        key = f"{prefix}{i}"
        write_wav(root / f"{key}.wav", x, sr=SR)
        np.save(root / f"{key}.npy", rng.random(
            (cfg.num_frames(s), cfg.num_bins)).astype(np.float32))
        wav_lines.append(f"{key} {root}/{key}.wav")
        mask_lines.append(f"{key} {root}/{key}.npy")
    (root / "wav.scp").write_text("\n".join(wav_lines) + "\n")
    (root / "mask.scp").write_text("\n".join(mask_lines) + "\n")
    return [f"{prefix}{i}" for i in range(len(lengths))]


# ---- the planar and spectrum-domain geometries (kernels 9-12) ----
P1_FIELDS = {"frame_len": 1024, "frame_hop": 512}
P2_S = 128100                    # 8 s and 100 samples: off the hop grid
E_FIELDS = {"frame_len": 512, "frame_hop": 128}
PLANAR_SET = {"stft_planar", "pair_covar_complement", "mvdr_power",
              "beamform_istft_planar"}
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


def _flops_beamform_istft_planar(b, n, t, n_fft):
    """Per frame: conj(w) x over the mics at n_fft/2 bins (8 FLOP a mic and
    bin, 2 at the Nyquist bin), then kernel 10's inverse."""
    return (b * t * n * (8 * (n_fft // 2) + 2) +
            _flops_istft_planar(b, t, n_fft))


def _flops_pair_covar(b, n, t, f, complement):
    """Per (frame, bin): the pair products (3 + 3 FLOP off the diagonal,
    3 on it) and the two masked sums (4 FLOP a complex entry, 2 on the
    diagonal); the complement mask costs 2 more."""
    per = 14 * n * (n - 1) // 2 + 7 * n + (2 if complement else 0)
    return b * t * f * per


def _all_counted():
    from setk_tpu_torch.ops.cuda import cacgmm_em as ce
    from setk_tpu_torch.ops.cuda import cholesky as ch
    from setk_tpu_torch.ops.cuda import covariance as mc
    from setk_tpu_torch.ops.cuda import covariance_pair as cp
    from setk_tpu_torch.ops.cuda import eigh_small as es
    from setk_tpu_torch.ops.cuda import fused_mvdr as fm
    from setk_tpu_torch.ops.cuda import lstm_seq as ls
    from setk_tpu_torch.ops.cuda import mvdr as mv
    from setk_tpu_torch.ops.cuda import planar as pl
    from setk_tpu_torch.ops.cuda import wpe_gram as wg
    return (fm.stft_covar, fm.beamform_istft, fm.covar_ema,
            fm.beamform_istft_online, mv.mvdr_power, mv.gevd_power,
            mv.pmwf_solve, mv.capon, pl.stft_planar, pl.istft_planar,
            pl.beamform_istft_planar,
            cp.pair_covar_complement, cp.pair_covar, mc.masked_covar,
            es.regularized_inverse, es.hermitian_eigh, ce.em,
            ch.hermitian_solve_lanes,
            ch.solve_wpe_gram, wg.wpe_gram, wg.wpe_apply,
            ls.lstm_seq_forward, ls.lstm_seq_forward_resident,
            ls.lstm_seq_forward_stream, ls.lstm_seq_backward,
            ls.lstm_seq_backward_resident, ls.lstm_seq_backward_stream)


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
    (kernel 10 on mic 0's planes, the shape of a beamformed spectrum, and
    with the beamform on every mic's planes and weights of a seeded
    generator, |w| ~ 1 / N as the MVDR weights).  Returns the relative
    and absolute errors and the tensors the timing reuses."""
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
    b, n = wav_d.shape[:2]
    gen = torch.Generator(device=dev).manual_seed(17)
    w = torch.complex(*torch.randn((2, b, fh + 1, n), device=dev,
                                   generator=gen)) / n
    out_w = pl.beamform_istft_planar(*plain, w, window, wss, s)
    out_wp = pl.beamform_istft_planar_plain(*plain, w, window, wss, s)
    torch.cuda.synchronize()
    rel = {"stft_planar": err9 / peak, "pair_covar_complement": err11[0],
           "istft_planar": _rel(out, out_p),
           "beamform_istft_planar": _rel(out_w, out_wp)}
    ab = {"stft_planar": err9, "pair_covar_complement": err11[1],
          "istft_planar": _abs(out, out_p),
          "beamform_istft_planar": _abs(out_w, out_wp)}
    return rel, ab, {"window": window, "planes": plain, "mask": msk, "t": t,
                     "nums": nums, "er": er, "ei": ei, "ny": ny, "wss": wss,
                     "out": out, "w": w, "out_w": out_w}


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
    """torch.profiler over ``iters`` calls of ``run`` after a warm-up, and
    one more warm-up call as the profiler's own warm-up step (traced, not
    kept): ms a call of device time by kernel (the ``top`` largest) and
    their sum; the idle share is the part of the unprofiled step time
    ``step_ms`` (CUDA events, free of the profiler's host overhead) with no
    kernel running."""
    from torch.profiler import ProfilerActivity, profile, schedule
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters,
                                   repeat=1)) as prof:
        for _ in range(iters + 1):
            run()
            torch.cuda.synchronize()
            prof.step()
    # the schedule's ProfilerStep ranges come back as device events too
    kernels = sorted(
        ((ev.self_device_time_total / 1e3 / iters, ev.key[:70])
         for ev in prof.key_averages()
         if ev.device_type == torch.autograd.DeviceType.CUDA and
         not ev.key.startswith("ProfilerStep")),
        reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    return {"step_ms": step_ms, "device_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / step_ms,
            "top": [[name, ms] for ms, name in kernels[:top]]}


# ---- clustering: CGMM/CACGMM mask estimation (kernels 13-15) ----
CL_ITERS = 20          # the clustering CLIs' default
CL_CHECK_ITERS = 4     # kernels against plain (tests/test_pallas.py bars)
CL_BUCKET = 128        # BatchClusterer's frame bucket
CL_SWEEPS = 6          # the Jacobi sweeps of kernels 14 and 15
CL_RESUME_ITERS = 5    # the CLI's resume run in C3
EM_SET = {"em"}
EM_BARS = {"gamma": 2e-3, "q_rtol": 2e-3, "q_atol": 1e-3, "alpha": 2e-3,
           "covar": 2e-2}


def _pair_flops(n):
    """conj(y_a) y_c for every pair a <= c: 3 FLOP on the diagonal, 6
    off it."""
    return 3 * n + 6 * n * (n - 1) // 2


def _flops_masked_covar(bins, n, t, k):
    """Per (frame, bin): the pair products, then per class a multiply-add
    for each real (2 FLOP) or complex (4) entry of the upper triangle."""
    return bins * t * (_pair_flops(n) + k * (2 * n + 4 * n * (n - 1) // 2))


def _flops_jacobi(m, sweeps):
    """One matrix: per rotation ~25 FLOP of angle and phase and three
    M-long complex updates (columns, rows, V) of 20 FLOP an entry; then
    the floored inverse V diag(1/w) V^H (8 FLOP a term) and the logdet."""
    rot = 25 + 3 * m * 20
    return (sweeps * m * (m - 1) // 2 * rot + m * (m + 1) // 2 * m * 8 +
            4 * m)


def _flops_em(bins, m, t, k, iters, sweeps):
    """Per bin, as the fused pass needs it: the Higuchi init's covariance
    pass (pair products and one accumulation), then iters + 1 E-steps (pair
    products, K quadratic forms, the posterior, one Jacobi a class), the
    first iters of which also carry the next M-step's gamma sums, weights
    and K accumulations on the same pair products."""
    acc = k * (2 * m + 4 * m * (m - 1) // 2)
    quad = k * (2 * m + 5 * m * (m - 1) // 2)
    m_step = t * (acc + 6 * k)
    e_step = t * (_pair_flops(m) + quad + 6 * k + 4) + k * _flops_jacobi(
        m, sweeps)
    init = t * (_pair_flops(m) + acc // k)
    return bins * (init + iters * m_step + (iters + 1) * e_step)


def _cluster_batch(np, items, bucket):
    """(obs (B, F, M, bucket) complex64, frame mask (B, 1, bucket)) padded
    as BatchClusterer pads: 1e-6 past each utterance's frames."""
    f, m = items[0].shape[:2]
    obs = np.zeros((len(items), f, m, bucket), np.complex64)
    fm = np.zeros((len(items), 1, bucket), np.float32)
    for i, o in enumerate(items):
        t = o.shape[-1]
        obs[i, ..., :t] = o
        obs[i, ..., t:] = 1e-6
        fm[i, 0, :t] = 1.0
    return obs, fm


def _cluster_plain(torch, algo, obs, fm, iters, seed):
    """BatchClusterer's K=2 EM call through kernel 15's plain version on
    the same device: cgmm from the Higuchi init, cacgmm from the uniform
    gamma of a generator seeded as BatchClusterer seeds it.  Returns
    (gamma, Q history)."""
    from setk_tpu_torch.enhance.cluster import _uniform_init, norm_observation
    from setk_tpu_torch.ops.cuda import cacgmm_em as ce
    if algo == "cgmm":
        return ce.em_plain(obs, None, None, iters, "cg", False,
                           frame_mask=fm, init="higuchi")
    gen = torch.Generator(device=obs.device)
    gen.manual_seed(seed)
    g0 = _uniform_init(2, (*obs.shape[:-2], obs.shape[-1]), obs, gen)
    return ce.em_plain(norm_observation(obs, axis=-2), g0,
                       torch.ones_like(g0), iters, "cacg", True,
                       frame_mask=fm)


def _em_errs(torch, got, ref):
    """Kernel 15 against its plain version: the errors EM_BARS bounds."""
    (g, q, st), (gp, qp, stp) = got, ref
    q_excess = float(((q - qp).abs() - EM_BARS["q_rtol"] * qp.abs()).max())
    return {"gamma": _abs(g, gp), "q_abs": _abs(q, qp),
            "q_rel": float(((q - qp).abs() / qp.abs()).max()),
            "q_over_bar": q_excess,
            "alpha": _abs(st["alpha"], stp["alpha"]),
            "covar": _rel(st["covar"], stp["covar"])}


# ---- WPE dereverberation and factored WPD (kernels 16-19) ----
# the JAX package's bench rows (benchmarks/bench_secondary.py:113-133) and
# recipes/run_wpe.sh: B = 32, 6 mics, 8 s (WPD 4 s), taps 10, delay 3,
# context 1, 3 iterations; WPD 3 outer iterations, CGMM 10
W_B, W_SECS, WPD_SECS = 32, 8, 4
WPD_T = WPD_SECS * 16000 // 256 + 1   # 251 frames at 512/256
W_TAPS, W_DELAY, W_CONTEXT, W_ITERS = 10, 3, 1, 3
WPD_OUTER, WPD_CGMM = 3, 10
# W3's utterances besides the B 8 s ones: (key, samples, seed); u6.144s
# fills its 98304-sample bucket, so its frames are not zero-padded
W_EXTRA = (("x3s", 48000, 31), ("x5.5s", 88000, 32), ("x30s", 480000, 33),
           ("u6.144s", 98304, 34))
WPE_SET = {"wpe_gram", "solve_wpe_gram", "wpe_apply"}
WPD_SET = WPE_SET | {"em", "pair_covar", "mvdr_power"}
# the CPU tests' bars: solves rtol 1e-3 + atol 1e-4 (tests/test_pallas.py:
# 196), equilibrated 5e-3 of the peak (:793), fused against plain 2e-3 of
# the peak (:618); Grams and the application TOL of the peak
W_RTOL, W_ATOL, W_EQ_TOL, W_FUSED_TOL = 1e-3, 1e-4, 5e-3, 2e-3
W5_BAR = 0.995   # WPD's enhanced cosine and mask correlation (W5)
# Where the f32 loop is ill conditioned the plain versions on the card are
# no sound reference (their cuBLAS Grams lie 0.158 of the peak from a
# float64 run on the reverberant scene), so the kernels are held against
# a float64 run of the plain loop at fixed bars: no further than the f32
# plain loop on the CPU lies (CPU BLAS Grams, the closest f32 loop measured),
# rounded up to one digit.  Readings of tools/wpe_precision.py on an
# NVIDIA H100 80GB HBM3 at 700 W: on the reverberant scene (condition
# numbers of the tap correlation up to 2e6) the CPU loop lies 1.76e-2 of
# the peak (largest |diff|) from float64, and over utterances the median
# of each one's largest |diff| over its peak is 1.21e-3, inside the fused
# bar W_FUSED_TOL; on zero-padded noise (BatchWpe's buckets; condition
# numbers ~1e7, where even float64 Grams with an f32 solve lie 2.8e-2
# away) 6.09e-2 of an utterance's peak.
W_REV_MAX, W_PAD_TOL = 2e-2, 7e-2


def _wpe_scene(b, n, s, seed, reverb):
    """(B, N, S) float32: noise at 0.2 (bench_secondary.py:123-127), or a
    source at 0.2 reaching mic k one sample later per mic through ten
    echoes 3-60 ms late at 0.6^d, plus noise at 0.02."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if not reverb:
        return rng.standard_normal((b, n, s)).astype(np.float32) * 0.2
    dry = rng.standard_normal((b, s)).astype(np.float32) * 0.2
    wav = rng.standard_normal((b, n, s)).astype(np.float32) * 0.02
    for k in range(n):
        wav[:, k] += np.roll(dry, k, axis=-1)
        for d in range(1, 11):
            lag = 48 + 96 * (d - 1) + 7 * k
            wav[:, k, lag:] += 0.6**d * dry[:, :s - lag]
    return wav


def _spectra(torch, wav_d, cfg):
    """(B, F, N, T) complex64 of (B, N, S) float32 on the card."""
    from setk_tpu_torch.dsp.stft import forward_stft
    return forward_stft(wav_d, cfg).permute(0, 3, 1, 2).contiguous()


def _wpe_plain(obs, taps, delay, context, iters):
    """The fused WPE loop through the plain versions of kernels 18, 17,
    19: (..., F, N, T) -> the same."""
    from setk_tpu_torch.ops.cuda import cholesky as ch
    from setk_tpu_torch.ops.cuda import wpe_gram as wg
    *lead, f, n, t = obs.shape
    flat = obs.reshape(-1, n, t)
    g = None
    for i in range(iters):
        gram = wg.wpe_gram_plain(flat, g, taps, delay, context, i > 0)
        g = ch.solve_wpe_gram_plain(gram, n, n * taps, n)
    return wg.wpe_apply_plain(flat, g, taps, delay).reshape(obs.shape)


class _PlainKernels:
    """Within the block every kernel wrapper on the WPE and WPD paths
    (16-19, the EM, the pair covariance, the MVDR solve) is its plain
    version: the same call through the plain versions on the card."""

    def __enter__(self):
        from setk_tpu_torch.enhance import wpe as tw
        from setk_tpu_torch.ops import linalg as tla
        from setk_tpu_torch.ops.cuda import cacgmm_em as ce
        from setk_tpu_torch.ops.cuda import cholesky as ch
        from setk_tpu_torch.ops.cuda import covariance_pair as cp
        from setk_tpu_torch.ops.cuda import mvdr as mv
        from setk_tpu_torch.ops.cuda import wpe_gram as wg
        self.swaps = [(tw, "wpe_gram", wg.wpe_gram_plain),
                      (tw, "solve_wpe_gram", ch.solve_wpe_gram_plain),
                      (tw, "wpe_apply", wg.wpe_apply_plain),
                      (tw, "mvdr_power", mv.mvdr_power_plain),
                      (tla, "hermitian_solve_lanes",
                       ch.hermitian_solve_lanes_plain),
                      (ce, "em", ce.em_plain),
                      (cp, "pair_covar", cp.pair_covar_plain)]
        self.saved = [(m, a, getattr(m, a)) for m, a, _ in self.swaps]
        for m, a, fn in self.swaps:
            setattr(m, a, fn)
        return self

    def __exit__(self, *exc):
        for m, a, fn in self.saved:
            setattr(m, a, fn)
        return False


def _allclose_excess(got, ref, rtol, atol):
    """max(|got - ref| - rtol |ref|) - atol: <= 0 where allclose holds."""
    return float(((got - ref).abs() - rtol * ref.abs()).max()) - atol


def _tri(n):
    return n * (n + 1) // 2


def _flops_wpe_gram(bins, n, taps, t, use_g):
    """Per frame and bin 8 FLOP for each (i <= j) Gram entry, and with
    ``use_g`` 8 for each of the dereverberation's N x N taps products."""
    cols = (taps + 1) * n
    return bins * t * 8 * (_tri(cols) + (n * n * taps if use_g else 0))


def _flops_wpe_apply(bins, n, taps, t):
    return bins * t * 8 * n * n * taps


def _flops_chol_solve(bins, n, k):
    return bins * (_chol_flops(n) + k * _solve_flops(n))


def _time_batch_wpe(executor, utts):
    results = {}
    for key, x in utts.items():
        results.update(executor.add(key, x))
    results.update(executor.flush())
    return results


def _wpe_slice(np, torch, dev, cfg):
    """Phases W1-W5 and the timing of kernels 16-19: returns (the kernels
    line's rows for 16-19, a summary of the steps)."""
    from setk_tpu_torch.dsp.stft import inverse_stft
    from setk_tpu_torch.enhance import wpe as tw
    from setk_tpu_torch.enhance.wpe import compute_lambda
    from setk_tpu_torch.ops.cuda import _build
    from setk_tpu_torch.ops.cuda import cholesky as ch
    from setk_tpu_torch.ops.cuda import wpe_gram as wg
    from setk_tpu_torch.parallel.executor import BatchWpe
    eps = 1.1920929e-07
    n, taps, delay, ctx = N, W_TAPS, W_DELAY, W_CONTEXT
    nk, s_w = n * taps, W_SECS * SR

    # ---- W1: kernels 16-19 against their plain versions ----
    errs = {k: 0.0 for k in ("wpe_gram", "solve_wpe_gram", "wpe_apply",
                             "hermitian_solve_lanes")}
    abs_errs = dict(errs)
    w1 = {}

    def held(name, got, ref, how):
        """Record got against ref; how is "peak" (TOL of the peak),
        "solve" (W_FUSED_TOL of the peak: a WPE Gram's solve, which two
        f32 operation orders part by its condition), "eq" (W_EQ_TOL of the
        peak) or "close" (W_RTOL, W_ATOL elementwise).  A kernel 18 Gram
        must also be exactly Hermitian with a real diagonal."""
        rel, ab = _rel(got, ref), _abs(got, ref)
        errs[name] = max(errs[name], rel)
        abs_errs[name] = max(abs_errs[name], ab)
        if how == "close":
            bad = _allclose_excess(got, ref, W_RTOL, W_ATOL) > 0
        else:
            bad = not rel <= {"peak": TOL, "solve": W_FUSED_TOL,
                              "eq": W_EQ_TOL}[how]
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"W1 {name} ({how}): kernel vs plain "
                                 f"relative {rel}, absolute {ab}")
        if name == "wpe_gram" and not (
                torch.equal(got, got.conj().transpose(-1, -2)) and
                float(torch.diagonal(got, dim1=-2, dim2=-1).imag.abs().max())
                == 0.0):
            raise AssertionError("W1 wpe_gram: the kernel's Gram is not "
                                 "exactly Hermitian with a real diagonal")
        return rel

    scenes = {}
    wav_n = _wpe_scene(W_B, n, s_w, 20, False)
    wav_r = _wpe_scene(W_B, n, s_w, 21, True)
    for label, reverb in (("noise", False), ("reverberant", True)):
        wav = torch.from_numpy(wav_r if reverb else wav_n).to(dev)
        obs = _spectra(torch, wav, cfg)
        scenes[label] = obs
        flat = obs.reshape(-1, n, obs.shape[-1])
        t = flat.shape[-1]
        gram0 = wg.wpe_gram(flat, None, taps, delay, ctx, use_g=False)
        gram0_p = wg.wpe_gram_plain(flat, None, taps, delay, ctx, False)
        row = {"gram_first": held("wpe_gram", gram0, gram0_p, "peak")}
        x_p = ch.solve_wpe_gram_plain(gram0_p, n, nk, n)
        row["solve"] = held("solve_wpe_gram", ch.solve_wpe_gram(
            gram0_p, n, nk, n), x_p, "solve")
        gram1_p = wg.wpe_gram_plain(flat, x_p, taps, delay, ctx, True)
        row["gram_use_g"] = held("wpe_gram", wg.wpe_gram(
            flat, x_p, taps, delay, ctx, True), gram1_p, "peak")
        row["apply"] = held("wpe_apply", wg.wpe_apply(flat, x_p, taps,
                                                      delay),
                            wg.wpe_apply_plain(flat, x_p, taps, delay),
                            "peak")
        lam = compute_lambda(obs, ctx).reshape(-1, t).contiguous()
        gram_l_p = wg.wpe_gram_plain(flat, None, taps, delay, 0, False, lam)
        row["gram_lambda"] = held("wpe_gram", wg.wpe_gram(
            flat, None, taps, delay, 0, False, lam), gram_l_p, "peak")
        e_eq = 4.0 * nk * eps
        row["solve_equilibrated"] = held(
            "solve_wpe_gram", ch.solve_wpe_gram(gram_l_p, n, nk, n, e_eq,
                                                True),
            ch.solve_wpe_gram_plain(gram_l_p, n, nk, n, e_eq, True), "eq")
        corr = gram1_p[:, n:, n:].contiguous()
        cross = gram1_p[:, n:, :n].contiguous()
        row["lanes_60"] = held("hermitian_solve_lanes",
                               ch.hermitian_solve_lanes(corr, cross),
                               ch.hermitian_solve_lanes_plain(corr, cross),
                               "solve")
        # NK = 9 and 30: the first three mics at taps 3 and 10
        sub = flat[:, :3].contiguous()
        for tp in (3, 10):
            g3 = wg.wpe_gram_plain(sub, None, tp, delay, ctx, False)
            for eq in (False, True):
                e = 4.0 * 3 * tp * eps if eq else 1e-6
                row[f"solve_nk{3 * tp}{'_eq' if eq else ''}"] = held(
                    "solve_wpe_gram",
                    ch.solve_wpe_gram(g3, 3, 3 * tp, 3, e, eq),
                    ch.solve_wpe_gram_plain(g3, 3, 3 * tp, 3, e, eq),
                    "eq" if eq else "solve")
        w1[label] = row
    # n = 128 (8 mics, taps 16): kernel 18 at cols = 136 in several passes
    # and kernel 16 through its dynamic shared memory
    wav8 = torch.from_numpy(_wpe_scene(4, 8, s_w, 22, True)).to(dev)
    flat8 = _spectra(torch, wav8, cfg).reshape(-1, 8, cfg.num_frames(s_w))
    g8_p = wg.wpe_gram_plain(flat8, None, 16, delay, ctx, False)
    w1["n8_taps16"] = {
        "gram": held("wpe_gram", wg.wpe_gram(flat8, None, 16, delay, ctx,
                                             False), g8_p, "peak"),
        "lanes_128": held(
            "hermitian_solve_lanes", ch.hermitian_solve_lanes(
                g8_p[:, 8:, 8:].contiguous(), g8_p[:, 8:, :8].contiguous()),
            ch.hermitian_solve_lanes_plain(g8_p[:, 8:, 8:].contiguous(),
                                           g8_p[:, 8:, :8].contiguous()),
            "solve")}
    # the CPU tests' systems at the CPU tests' bars (tests/test_pallas.py:
    # 793: a rank-6 Gram plus 0.5 I; a copy with rows scaled over ~5
    # decades, equilibrated, eps_rel 1e-5), one a bin of the scene
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    n_sys = W_B * cfg.num_bins

    def synth(cols):
        a = torch.complex(torch.randn(n_sys, cols, 6, generator=gen,
                                      device=dev),
                          torch.randn(n_sys, cols, 6, generator=gen,
                                      device=dev))
        return (a @ a.conj().transpose(-1, -2) + 0.5 * torch.eye(
            cols, device=dev)).contiguous()

    synth_row = {}
    for nk_s, n0 in ((9, 3), (30, 3), (60, 6)):
        gs = synth(n0 + nk_s)
        synth_row[f"solve_nk{nk_s}"] = held(
            "solve_wpe_gram", ch.solve_wpe_gram(gs, n0, nk_s, n0),
            ch.solve_wpe_gram_plain(gs, n0, nk_s, n0), "close")
        sc = torch.exp(torch.rand(n_sys, n0 + nk_s, generator=gen,
                                  device=dev) * 12 - 6)
        gs = (gs * (sc[:, :, None] * sc[:, None, :])).contiguous()
        synth_row[f"solve_nk{nk_s}_eq"] = held(
            "solve_wpe_gram", ch.solve_wpe_gram(gs, n0, nk_s, n0, 1e-5, True),
            ch.solve_wpe_gram_plain(gs, n0, nk_s, n0, 1e-5, True), "eq")
    for nn in (60, 128):
        gs = synth(nn + 8)
        a_s = gs[:, 8:, 8:].contiguous()
        b_s = gs[:, 8:, :8].contiguous()
        synth_row[f"lanes_{nn}"] = held(
            "hermitian_solve_lanes", ch.hermitian_solve_lanes(a_s, b_s),
            ch.hermitian_solve_lanes_plain(a_s, b_s), "close")
    w1["synthetic"] = synth_row
    torch.cuda.synchronize()
    print(json.dumps({"W1_kernel_vs_plain_max_rel_err": w1,
                      "bars": {"peak": TOL, "solve": W_FUSED_TOL,
                               "equilibrated": W_EQ_TOL,
                               "synthetic_rtol": W_RTOL,
                               "synthetic_atol": W_ATOL}}))

    # ---- W2: wpe at full width ----
    # on the noise scene the loop is well conditioned: the kernels within
    # W_FUSED_TOL of the same loop through the plain versions.  On the
    # reverberant scene WPE nearly cancels the echoes and lambda collapses:
    # the kernels' loop within W_REV_MAX of the peak of a float64 run, and
    # the median utterance within W_FUSED_TOL of its peak
    want = {"wpe_gram": W_ITERS, "solve_wpe_gram": W_ITERS, "wpe_apply": 1}
    w2 = {}
    for label, obs_s in scenes.items():
        fused, c_fused = _launched(torch, lambda: tw.wpe(obs_s),
                                   f"W2 wpe fused {label}", WPE_SET)
        plain = _wpe_plain(obs_s, taps, delay, ctx, W_ITERS)
        row = {"fused_launches": c_fused, "fused_vs_plain": _rel(fused, plain),
               "finite": bool(torch.isfinite(fused).all())}
        if label == "reverberant":
            exact = _wpe_plain(obs_s.to(torch.complex128), taps, delay, ctx,
                               W_ITERS)
            row["fused_vs_f64"] = _rel(fused.to(exact.dtype), exact)
            per_utt = ((fused.to(exact.dtype) - exact).abs().flatten(1)
                       .amax(1) / exact.abs().flatten(1).amax(1))
            row["fused_vs_f64_median_utterance"] = float(
                per_utt.quantile(0.5))
            row["plain_vs_f64"] = _rel(plain.to(exact.dtype), exact)
            del exact, per_utt
            ok = row["fused_vs_f64"] <= W_REV_MAX and \
                row["fused_vs_f64_median_utterance"] <= W_FUSED_TOL
        else:
            ok = row["fused_vs_plain"] <= W_FUSED_TOL
        w2[label] = row
        if c_fused != want or not row["finite"] or not ok:
            raise AssertionError(f"W2 wpe {label}: {row}")
    obs_w = scenes["noise"]
    scan, c_scan = _launched(torch, lambda: tw.wpe(obs_w, use_fused=False),
                             "W2 wpe scan", {"hermitian_solve_lanes"})
    t_chirp = np.arange(4 * SR) / SR
    chirp = np.sin(2 * np.pi * (300 + 600 * t_chirp) * t_chirp).astype(
        np.float32) * 0.5
    mix = chirp[None] + np.random.default_rng(23).standard_normal(
        (n, t_chirp.size)).astype(np.float32) * 0.25
    chirp_out = tw.wpe(_spectra(torch, torch.from_numpy(mix[None]).to(dev),
                                cfg))
    w2.update(scan_launches=c_scan,
              scan_vs_fused=_rel(scan, tw.wpe(obs_w)),
              chirp_finite=bool(torch.isfinite(chirp_out).all()))
    print(json.dumps({"W2_wpe": w2, "tol": W_FUSED_TOL,
                      "reverberant_tol": W_REV_MAX}))
    if c_scan != {"hermitian_solve_lanes": W_ITERS} or \
            not w2["chirp_finite"]:
        raise AssertionError(f"W2 wpe: {w2}")

    # ---- W3: BatchWpe over keyed utterances ----
    # the bench scene (noise at 0.2): B utterances of 8 s and W_EXTRA; then
    # the reverberant scene's 8 s utterances, whose bucket pads 12 frames
    utts = {f"w{i:02d}": wav_n[i] for i in range(W_B)}
    for key, samples, seed in W_EXTRA:
        utts[key] = _wpe_scene(1, n, samples, seed, False)[0]
    executor = BatchWpe(cfg, taps=taps, delay=delay, context=ctx,
                        num_iters=W_ITERS, batch_size=W_B, device="cuda")

    def against_plain(utts, res, exact=True):
        """Each output against the plain path on the card, bucket by
        bucket as BatchWpe pads, and (``exact``) against a float64 run of
        the plain path: (over the zero-padded outputs, the largest error
        relative to an utterance's peak of the kernels' output and of the
        f32 plain output from the f64 run; over the outputs that fill their
        bucket, the kernels' largest error from the f32 plain output; keys
        not finite on the card; keys not finite on the plain path; bucket
        count); errors over outputs finite on both paths."""
        buckets = {}
        for key, x in utts.items():
            buckets.setdefault(executor.bucketer.bucket(x.shape[-1]),
                               []).append(key)
        err_k, err_p, err_kp, bad_k, bad_p = 0.0, 0.0, 0.0, [], []
        for bucket, keys in buckets.items():
            wv = np.zeros((len(keys), n, bucket), np.float32)
            for i, key in enumerate(keys):
                wv[i, :, :utts[key].shape[-1]] = utts[key]
            spec = _spectra(torch, torch.from_numpy(wv).to(dev), cfg)
            refs = []
            for dtype in ((torch.complex64, torch.complex128) if exact
                          else (torch.complex64,)):
                der = _wpe_plain(spec.to(dtype), taps, delay, ctx, W_ITERS)
                refs.append(inverse_stft(der.permute(0, 2, 3, 1), cfg,
                                         nsamps=bucket).cpu().numpy())
                del der
            for i, key in enumerate(keys):
                got, x = res[key], utts[key]
                if got.shape != x.shape:
                    raise AssertionError(f"W3 {key}: bad shape {got.shape}")
                r32 = refs[0][i, :, :x.shape[-1]]
                fin_k, fin_p = np.isfinite(got).all(), np.isfinite(r32).all()
                if not fin_k:
                    bad_k.append(key)
                if not fin_p:
                    bad_p.append(key)
                if fin_k and fin_p and x.shape[-1] == bucket:
                    err_kp = max(err_kp, float(np.abs(got - r32).max() /
                                               np.abs(r32).max()))
                elif fin_k and fin_p:
                    if exact:
                        r64 = refs[1][i, :, :x.shape[-1]]
                        peak = np.abs(r64).max()
                        err_k = max(err_k, float(np.abs(got - r64).max() /
                                                 peak))
                        err_p = max(err_p, float(np.abs(r32 - r64).max() /
                                                 peak))
        return err_k, err_p, err_kp, bad_k, bad_p, len(buckets)

    t0 = time.perf_counter()
    res, c_batch = _launched(torch, lambda: _time_batch_wpe(executor, utts),
                             "W3 BatchWpe", WPE_SET)
    batch_s = time.perf_counter() - t0
    err_k, err_p, err_kp, bad_k, bad_p, nb = against_plain(utts, res)
    want = {"wpe_gram": W_ITERS * nb, "solve_wpe_gram": W_ITERS * nb,
            "wpe_apply": nb}
    w3 = {"launches": c_batch, "buckets": nb, "utterances": len(utts),
          "seconds": batch_s, "padded_kernels_vs_f64": err_k,
          "padded_plain_vs_f64": err_p, "unpadded_kernels_vs_plain": err_kp,
          "non_finite_card": bad_k, "non_finite_plain": bad_p}
    # padded frames get lambda = EPSILON (the JAX package's semantics,
    # kept): on the reverberant scene the padded tap Gram is indefinite
    # in f32 and the outputs are not finite on either path; recorded
    utts_r = {f"r{i:02d}": wav_r[i] for i in range(W_B)}
    res_r, c_r = _launched(torch, lambda: _time_batch_wpe(executor, utts_r),
                           "W3 BatchWpe reverberant", WPE_SET)
    _, _, _, bad_rk, bad_rp, _ = against_plain(utts_r, res_r, exact=False)
    w3["reverberant_padded"] = {"launches": c_r,
                                "non_finite_card": len(bad_rk),
                                "non_finite_plain": len(bad_rp),
                                "utterances": len(utts_r)}
    unpadded = [key for key, x in utts.items()
                if executor.bucketer.bucket(x.shape[-1]) == x.shape[-1]]
    w3["unpadded"] = unpadded
    print(json.dumps({"W3_BatchWpe": w3, "unpadded_tol": W_FUSED_TOL,
                      "padded_tol": W_PAD_TOL}))
    if c_batch != want or bad_k or bad_p or not err_k <= W_PAD_TOL or \
            not unpadded or not err_kp <= W_FUSED_TOL or \
            c_r != {k: v // nb for k, v in want.items()}:
        raise AssertionError(f"W3 BatchWpe: {w3}, launches need {want}")

    # ---- W4: the CLIs on the card against --device cpu ----
    # each CLI skips an utterance whose output is not finite; with the
    # padded-frame semantics above most of step 8's corpus is skipped by
    # the WPE CLI on the CPU (recorded).  A second corpus of lengths that
    # fill a sample bucket (65536, 131072: no padded frame on the batched
    # path) or a 64-frame bucket (65280, 130816: none on the per-utterance
    # path) must be written on both sides where its path pads nothing.
    from setk_tpu_torch.cli import apply_wpd as wpd_cli
    from setk_tpu_torch.cli import apply_wpe as wpe_cli
    from setk_tpu_torch.io.wave import read_wav
    w4 = {}
    fit = {"apply_wpe_b4": {"f0", "f2"}, "apply_wpe_b1": {"f1", "f3"},
           "apply_wpd": set()}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        keys = _write_corpus(tmp, seed=3)
        _write_corpus(tmp / "fit", seed=4,
                      lengths=(65536, 65280, 131072, 130816), prefix="f")
        for label, mod, extra, want in (
                ("apply_wpe_b4", wpe_cli, ["--batch-size", "4"], WPE_SET),
                ("apply_wpe_b1", wpe_cli, ["--batch-size", "1"], WPE_SET),
                ("apply_wpd", wpd_cli, [], WPD_SET)):
            outs, masks = {}, {}
            for device in ("cuda", "cpu"):
                outs[device] = {}
                for corpus in ((tmp,) if mod is wpd_cli else
                               (tmp, tmp / "fit")):
                    out = corpus / f"{label}-{device}"
                    argv = [str(corpus / "wav.scp"), str(out), "--device",
                            device] + extra
                    if mod is wpd_cli:
                        argv += ["--mask-dir", str(out) + "-masks"]
                    run = (lambda: mod.run(mod.make_parser().parse_args(
                        argv)))
                    if device == "cuda":
                        _, counts = _launched(torch, run, f"W4 {label}",
                                              want)
                        w4.setdefault(label, {}).setdefault(
                            "launches", []).append(counts)
                    else:
                        run()
                    for path in sorted(out.glob("*.wav")):
                        outs[device][path.stem] = read_wav(
                            path, normalize=False)
                    if mod is wpd_cli:
                        masks[device] = {
                            k: np.load(f"{out}-masks/{k}.npy")
                            for k in outs[device]}
            a, b = outs["cuda"], outs["cpu"]
            both = sorted(set(a) & set(b))
            row = w4[label]
            row.update(written_card=sorted(a), written_cpu=sorted(b),
                       must_write=sorted(fit[label]))
            row["max_int16_step"] = max(
                (float(np.abs(a[k] - b[k]).max()) for k in both), default=0)
            row["min_corr"] = min((float(np.corrcoef(
                a[k].ravel(), b[k].ravel())[0, 1]) for k in both), default=1)
            if masks:
                row["min_mask_corr"] = min(float(np.corrcoef(
                    masks["cuda"][k].ravel(), masks["cpu"][k].ravel())[0, 1])
                    for k in both)
                row["min_cosine"] = min(float(
                    np.abs((a[k] * b[k]).sum()) / np.sqrt(
                        (a[k] * a[k]).sum() * (b[k] * b[k]).sum()))
                    for k in both)
    print(json.dumps({"W4_cli_card_vs_cpu": w4, "utterances": len(keys),
                      "corr": 0.99}))
    for label, row in w4.items():
        if fit[label] - set(row["written_card"]) or \
                fit[label] - set(row["written_cpu"]) or not (
                    row["min_corr"] >= 0.99 and
                    row.get("min_mask_corr", 1) >= 0.99 and
                    row.get("min_cosine", 1) >= 0.99):
            raise AssertionError(f"W4 {label}: {row}")
    if len(w4["apply_wpd"]["written_cpu"]) != len(keys) or \
            len(w4["apply_wpd"]["written_card"]) != len(keys):
        raise AssertionError(f"W4 apply_wpd: {w4['apply_wpd']}")

    # ---- W5: wpd at B = 32 x 4 s ----
    # the bench's input (noise at 0.2, bench_secondary.py:84-91) against
    # the same call through the plain versions: three outer iterations of
    # chained CGMM over noise amplify rounding (first run on the card:
    # cosine 0.9985, mask correlation 0.9994), so the bar is W5_BAR,
    # between that and tests/test_wpe.py's fused-vs-XLA 0.99; the
    # reverberant scene (chained EM over a collapsing lambda) recorded,
    # and finite on both paths
    w5 = {}
    for label, reverb, seed in (("noise", False, 24), ("reverberant", True,
                                                       24)):
        wav_d = torch.from_numpy(_wpe_scene(W_B, n, WPD_SECS * SR, seed,
                                            reverb)).to(dev)
        obs_d = _spectra(torch, wav_d, cfg)

        def run_wpd(obs_d=obs_d):
            return tw.wpd(obs_d, cgmm_iters=WPD_CGMM, wpd_iters=WPD_OUTER,
                          taps=taps, delay=delay, context=ctx)

        (mask_k, enh_k), c_wpd = _launched(torch, run_wpd,
                                           f"W5 wpd {label}", WPD_SET)
        with _PlainKernels():
            mask_p, enh_p = run_wpd()
        w5[label] = {
            "launches": c_wpd,
            "enhanced_cosine": float((torch.vdot(
                enh_k.flatten(), enh_p.flatten()).abs() / (
                    torch.linalg.vector_norm(enh_k) *
                    torch.linalg.vector_norm(enh_p)))),
            "mask_corr": float(np.corrcoef(
                mask_k.cpu().numpy().ravel(),
                mask_p.cpu().numpy().ravel())[0, 1]),
            "finite": bool(torch.isfinite(enh_k).all() and
                           torch.isfinite(enh_p).all())}
        if label == "noise":
            wpd_run = run_wpd
    before = torch.cuda.memory_allocated()
    try:
        tw.wpd(np.zeros((cfg.num_bins, 9, 100), np.complex64), taps=2,
               device="cuda")
    except NotImplementedError as exc:
        w5["refusal"] = re.search(r"ROADMAP [^;,]*", str(exc)).group(0)
    else:
        raise AssertionError("W5: wpd outside the gate was not refused")
    w5["refusal_allocated"] = torch.cuda.memory_allocated() - before
    print(json.dumps({"W5_wpd": w5, "bar": W5_BAR}))
    for label in ("noise", "reverberant"):
        row = w5[label]
        if row["launches"] != {k: WPD_OUTER for k in WPD_SET} or \
                not row["finite"] or (label == "noise" and not (
                    row["enhanced_cosine"] >= W5_BAR and
                    row["mask_corr"] >= W5_BAR)):
            raise AssertionError(f"W5 wpd {label}: {w5}")
    if w5["refusal_allocated"]:
        raise AssertionError(f"W5 refusal allocated: {w5}")

    # ---- timing at the WPE scene ----
    flat = obs_w.reshape(-1, n, obs_w.shape[-1])
    t = flat.shape[-1]
    bins = flat.shape[0]
    g_w = ch.solve_wpe_gram_plain(wg.wpe_gram_plain(
        flat, None, taps, delay, ctx, False), n, nk, n)
    gram_w = wg.wpe_gram_plain(flat, g_w, taps, delay, ctx, True)
    corr = gram_w[:, n:, n:].contiguous()
    cross = gram_w[:, n:, :n].contiguous()
    x_w = ch.solve_wpe_gram(gram_w, n, nk, n)
    rows = [
        ("hermitian_solve_lanes", "setk_tpu/ops/pallas/cholesky.py:384",
         lambda: ch.hermitian_solve_lanes(corr, cross),
         lambda: ch.hermitian_solve_lanes_plain(corr, cross),
         _bound(corr.nbytes + cross.nbytes + x_w.nbytes,
                _flops_chol_solve(bins, nk, n)), c_scan),
        ("solve_wpe_gram", "setk_tpu/ops/pallas/cholesky.py:304",
         lambda: ch.solve_wpe_gram(gram_w, n, nk, n),
         lambda: ch.solve_wpe_gram_plain(gram_w, n, nk, n),
         _bound(bins * (_tri(nk) + nk * n) * 8 + x_w.nbytes,
                _flops_chol_solve(bins, nk, n)), c_batch),
        ("wpe_gram", "setk_tpu/ops/pallas/wpe_gram.py:292",
         lambda: wg.wpe_gram(flat, g_w, taps, delay, ctx, True),
         lambda: wg.wpe_gram_plain(flat, g_w, taps, delay, ctx, True),
         _bound(flat.nbytes + g_w.nbytes + gram_w.nbytes,
                _flops_wpe_gram(bins, n, taps, t, True)), c_batch),
        ("wpe_apply", "setk_tpu/ops/pallas/wpe_gram.py:344",
         lambda: wg.wpe_apply(flat, g_w, taps, delay),
         lambda: wg.wpe_apply_plain(flat, g_w, taps, delay),
         _bound(2 * flat.nbytes + g_w.nbytes,
                _flops_wpe_apply(bins, n, taps, t)), c_batch)]
    # for information only, never called by the port: the loaded
    # torch.linalg Cholesky solve of the same systems, and the weighted
    # Gram / application of a tap stack built beforehand
    load = ((1e-6 / nk) * torch.diagonal(corr, dim1=-2, dim2=-1).real.sum(
        -1) + eps)[:, None, None] * torch.eye(nk, device=dev)
    loaded = corr + load
    # library_ms, one PyTorch call of the same function on operands built
    # beforehand (never on the port's path): kernels 16 and 17
    # torch.linalg.solve of the loaded systems; kernel 19 one grouped
    # complex conv1d over the left-padded frames, a group a bin, whose
    # weights are the identity at lag 0 and -conj(G) at lags delay ...
    # delay + taps - 1 (conv1d correlates: lag j at kernel index lead - j)
    lead = delay + taps - 1
    w_conv = torch.zeros((bins, n, n, lead + 1), dtype=torch.complex64,
                         device=dev)
    w_conv[..., :taps] = -g_w.reshape(bins, taps, n, n).permute(
        0, 3, 2, 1).conj().flip(-1)
    w_conv[..., lead] += torch.eye(n, dtype=torch.complex64, device=dev)
    w_conv = w_conv.reshape(bins * n, n, lead + 1)
    x_conv = torch.nn.functional.pad(flat.reshape(1, bins * n, t), (lead, 0))
    library = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 products, as the kernels
    try:
        for name, fn, ref in (
                ("hermitian_solve_lanes",
                 lambda: torch.linalg.solve(loaded, cross),
                 ch.hermitian_solve_lanes_plain(corr, cross)),
                ("solve_wpe_gram", lambda: torch.linalg.solve(loaded, cross),
                 ch.solve_wpe_gram_plain(gram_w, n, nk, n)),
                ("wpe_apply", lambda: torch.nn.functional.conv1d(
                    x_conv, w_conv, groups=bins).reshape(flat.shape),
                 wg.wpe_apply_plain(flat, g_w, taps, delay))):
            library[name] = {
                "ms": _time_ms(torch, fn, iters=5, warmup=1),
                "max_rel_err": _rel(fn(), ref)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del x_conv, w_conv
    taps_m = wg.tap_rows(flat, taps, delay)
    sw = torch.rsqrt(torch.clamp(compute_lambda(flat, ctx), min=eps))
    stack = torch.cat([flat, taps_m], dim=-2) * sw[:, None, :]
    info = {}
    for label, fn in (
            ("linalg_cholesky_solve_ms_info", lambda: torch.cholesky_solve(
                cross, torch.linalg.cholesky(loaded))),
            ("tap_stack_gram_ms_info", lambda: stack @ stack.conj(
            ).transpose(-1, -2)),
            ("tap_stack_apply_ms_info", lambda: flat - g_w.conj().transpose(
                -1, -2) @ taps_m)):
        try:
            info[label] = _time_ms(torch, fn, iters=5, warmup=1)
        except RuntimeError as exc:
            info[label] = f"not measured: {str(exc)[:70]}"
    info_of = {"hermitian_solve_lanes": "linalg_cholesky_solve_ms_info",
               "solve_wpe_gram": "linalg_cholesky_solve_ms_info",
               "wpe_gram": "tap_stack_gram_ms_info",
               "wpe_apply": "tap_stack_apply_ms_info"}
    kernels = []
    for name, replaces, run_k, run_p, (bound_ms, bound_by), counts in rows:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "setk_tpu_torch/csrc/" + (
                "wpe_gram.cu" if name.startswith("wpe") else "cholesky.cu"),
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": abs_errs[name], "max_rel_err": errs[name],
            "ms": _graph_ms(torch, run_k, iters=10),
            "eager_ms": _time_ms(torch, run_k, iters=10),
            "plain_ms": _time_ms(torch, run_p, iters=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[name]["ms"] if name in library else None,
            info_of[name]: info[info_of[name]]})
        if name in library:
            kernels[-1]["library_max_rel_err"] = library[name][
                "max_rel_err"]
    steps = {}
    wpe_ms = _time_ms(torch, lambda: tw.wpe(obs_w), iters=5, warmup=1)
    wpd_ms = _time_ms(torch, wpd_run, iters=3, warmup=1)
    batch_utts = {k: v for k, v in utts.items() if k.startswith("w")}
    batch_ms = _time_ms(torch, lambda: _time_batch_wpe(executor, batch_utts),
                        iters=3, warmup=1)
    steps["wpe_B32_8s"] = {"ms": wpe_ms,
                           "audio_s_per_s": W_B * W_SECS / (wpe_ms / 1e3),
                           "profile": _device_profile(
                               torch, lambda: tw.wpe(obs_w), wpe_ms,
                               iters=3)}
    steps["wpe_scan_B32_8s_ms"] = _time_ms(
        torch, lambda: tw.wpe(obs_w, use_fused=False), iters=3, warmup=1)
    steps["wpd_B32_4s"] = {"ms": wpd_ms,
                           "audio_s_per_s": W_B * WPD_SECS / (wpd_ms / 1e3),
                           "profile": _device_profile(torch, wpd_run, wpd_ms,
                                                      iters=2)}
    steps["BatchWpe_32x8s"] = {
        "ms": batch_ms, "audio_s_per_s": W_B * W_SECS / (batch_ms / 1e3),
        "profile": _device_profile(torch, lambda: _time_batch_wpe(
            executor, batch_utts), batch_ms, iters=2)}
    print(json.dumps({"wpe_steps": steps}))
    return kernels, steps


# ---- the Hermitian EVD and the per-utterance CLI (V1-V3) ----
EIGH_SWEEPS = 8                 # ops/cuda/eigh_small.EIGH_SWEEPS, a cap
V_COUNTS = (257, 4112, 32896)   # one utterance; 8 s at chunk 32; B = 128
V_LIBRARY_COUNTS = (257, 4112, 16384, 32896)
V_GAP = 1e-3    # a principal vector counts where its eigenvalue stands
#                 this share of the peak above the next one
V_UTTS, V_SECS, V_CHUNK = 4, 8, 32
# (label, extra argv, the kernels one utterance launches and how often)
V2_OPTIONS = [
    ("mvdr", [], {"pair_covar": 1, "hermitian_eigh": 1}),
    ("gevd+ban", ["--beamformer", "gevd", "--ban", "true"],
     {"pair_covar": 1, "hermitian_eigh": 1}),
    ("mpdr", ["--beamformer", "mpdr"],
     {"pair_covar": 1, "masked_covar": 1, "hermitian_eigh": 1}),
    ("mpdr-whiten", ["--beamformer", "mpdr-whiten"],
     {"pair_covar": 1, "masked_covar": 1, "hermitian_eigh": 1}),
    ("pmwf-0+gev+ref0", ["--beamformer", "pmwf-0", "--rank1-appro", "gev",
                         "--pmwf-ref", "0"],
     {"pair_covar": 1, "hermitian_eigh": 1}),
    ("pmwf-1+itf", ["--beamformer", "pmwf-1", "--itf-mask", "ITF"],
     {"pair_covar": 1}),
    ("mvdr+vad0.9+mask", ["--vad-proportion", "0.9", "--mask", "true"],
     {"pair_covar": 1, "hermitian_eigh": 1}),
    ("online-gevd", ["--beamformer", "gevd", "--chunk-size", str(V_CHUNK)],
     {"masked_covar": 1, "hermitian_eigh": 1}),
    ("online-mvdr", ["--chunk-size", str(V_CHUNK)],
     {"masked_covar": 1, "hermitian_eigh": 1})]
V3_B = 32
V3_WPD_TAPS = 22                # N taps = 132 > 128: the WPD scan


def _flops_eigh(m, sweeps, gen):
    """One matrix: the sweeps' rotations as _flops_jacobi counts them; the
    generalized form adds two Cholesky factorizations, the whitening
    (2 M triangular substitutions) and the back substitution (M)."""
    rot = 25 + 3 * m * 20
    flops = sweeps * (m * (m - 1) // 2) * rot
    if gen:
        flops += 2 * _chol_flops(m) + 3 * m * _tri_flops(m)
    return flops


def _eigh_inputs(torch, dev, n, m, seed, scene=None):
    """(a, b) of n matrices: the gated scene's (Rs, Rn) where given (M =
    6), else a quarter rank one plus noise at 1e-3, the rest full rank
    (Wishart of M + 2 draws), b full rank; one all-zero a (a bin with no
    speech)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def herm(count, rank):
        x = torch.complex(*torch.randn((2, count, m, rank), device=dev,
                                       generator=gen))
        return x @ x.conj().transpose(-1, -2)

    if scene is not None:
        a, b = (x.reshape(-1, m, m)[:n].clone() for x in scene)
    else:
        a, b = herm(n, m + 2), herm(n, m + 3)
        a[:n // 4] = herm(n // 4, 1) + 1e-3 * herm(n // 4, m)
    a[-1] = 0
    return a.contiguous(), b.contiguous()


def _eigh_errs(torch, w, v, w_p, v_p):
    """(largest eigenvalue error over the matrix's peak, the largest
    absolute one, smallest |v^H v_ref| / norms of the principal vectors
    whose eigenvalue is above EPSILON x max and V_GAP of the peak above
    the next, matrices so counted)."""
    eps = 1.1920929e-07
    peak = w_p.abs().amax(-1).clamp(min=1e-30)
    w_err = float(((w - w_p).abs().amax(-1) / peak).max())
    top, top_p = v[..., -1], v_p[..., -1]
    cos = (top.conj() * top_p).sum(-1).abs() / (
        torch.linalg.vector_norm(top, dim=-1) *
        torch.linalg.vector_norm(top_p, dim=-1))
    keep = w_p[:, -1] > eps * peak
    if w_p.shape[-1] > 1:
        keep &= w_p[:, -1] - w_p[:, -2] > V_GAP * peak
    return (w_err, _abs(w, w_p), float(cos[keep].min()),
            int(keep.sum()))


def _write_gated_corpus(np, root, count, secs, seed):
    """``count`` gated-scene utterances (6 ch int16 wav, _gated_scene's
    source and 0.95/0.05 mask, a little jitter on the mask) with speech
    and interference masks (1 - mask) as .npy, and their scps."""
    from setk_tpu_torch.io.wave import write_wav
    root.mkdir(parents=True, exist_ok=True)
    wav16, mask, _ = _gated_scene(count, N, secs * SR, seed)
    rng = np.random.default_rng(seed)
    lines = {"wav": [], "mask": [], "itf": []}
    keys = []
    for i in range(count):
        key = f"v{i}"
        keys.append(key)
        write_wav(root / f"{key}.wav", wav16[i].astype(np.float32) / 32768,
                  sr=SR)
        jitter = rng.random(mask[i].shape).astype(np.float32) * 0.04
        np.save(root / f"{key}.npy", mask[i] - jitter)
        np.save(root / f"{key}.itf.npy", 1.0 - mask[i] + jitter)
        for name, suffix in (("wav", ".wav"), ("mask", ".npy"),
                             ("itf", ".itf.npy")):
            lines[name].append(f"{key} {root}/{key}{suffix}")
    for name, rows in lines.items():
        (root / f"{name}.scp").write_text("\n".join(rows) + "\n")
    return keys


def _evd_slice(np, torch, dev, card="cuda", counts=V_COUNTS,
               library_counts=V_LIBRARY_COUNTS, b=B, utts=V_UTTS,
               secs=V_SECS, v3_b=V3_B):
    """Phases V1-V3: returns (the kernels line's row for the EVD kernel,
    a summary).  ``card`` is the device the CLI and the entry points are
    asked for."""
    from setk_tpu_torch.cli import apply_adaptive_beamformer as cli
    from setk_tpu_torch.dsp.stft import StftConfig, forward_stft
    from setk_tpu_torch.enhance import wpe as tw
    from setk_tpu_torch.enhance.pipeline import enhance_plain
    from setk_tpu_torch.io.wave import read_wav
    from setk_tpu_torch.ops.cuda import _build
    from setk_tpu_torch.ops.cuda import eigh_small as es
    from setk_tpu_torch.ops.cuda import fused_mvdr as fm
    from setk_tpu_torch.parallel.enhance_step import enhance_batch
    cfg = StftConfig()
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)

    # ---- V1: the EVD kernel against its plain version ----
    gwav16, gmask, _ = _gated_scene(b, N, S, seed=1)
    gmask_d = torch.from_numpy(gmask).to(dev)
    rs_num, rn_num = fm.stft_covar(torch.from_numpy(gwav16).to(dev),
                                   gmask_d, window)
    den = gmask_d.sum(1)
    scene = (rs_num / torch.clamp(den, min=1e-6)[..., None, None],
             rn_num / torch.clamp(cfg.num_frames(S) - den,
                                  min=1e-6)[..., None, None])
    v1 = {}
    for m in range(1, 9):
        for n in counts:
            a, bm = _eigh_inputs(torch, dev, n, m, seed=100 * m + n % 97,
                                 scene=scene if m == N else None)
            for gen in (False, True):
                bb = bm if gen else None
                w_p, v_p = es.hermitian_eigh_plain(a, bb)
                for form in es.eigh_forms(m):
                    w, v = es.hermitian_eigh(a, bb, form=form)
                    w_err, w_abs, cos, kept = _eigh_errs(torch, w, v, w_p,
                                                         v_p)
                    v1[f"M{m},n{n},{'gen' if gen else 'eigh'},{form}"] = {
                        "w_err": w_err, "w_abs_err": w_abs,
                        "principal_min_cos": cos,
                        "counted": kept,
                        "finite": bool(torch.isfinite(w[:-1]).all() and
                                       torch.isfinite(v[:-1]).all())}
    w_worst = max(r["w_err"] for r in v1.values())
    cos_worst = min(r["principal_min_cos"] for r in v1.values())
    print(json.dumps({"V1_eigh_vs_plain": v1, "w_bar": TOL,
                      "cos_bar": 1 - 1e-5, "gap": V_GAP}))
    if not (w_worst <= TOL and cos_worst >= 1 - 1e-5 and
            all(r["finite"] for r in v1.values())):
        raise AssertionError(f"V1: eigenvalue error {w_worst} (bar {TOL}) "
                             f"or principal cosine {cos_worst}")
    # times at M = 6 on the gated scene's covariances, plain and
    # generalized, each form and the launcher's pick; the bound from the
    # sweeps these matrices take
    t1 = {}
    for n in counts:
        a, bm = _eigh_inputs(torch, dev, n, N, seed=7, scene=scene)
        for gen in (False, True):
            bb = bm if gen else None
            nbytes = a.nbytes * (2 if gen else 1) + a.nbytes + n * N * 4
            taken = es.eigh_sweeps_needed(a, bb)
            row = t1[f"n{n},{'gen' if gen else 'eigh'}"] = {
                "form": es.eigh_form(n, N),
                "plain_ms": _time_ms(torch, lambda: es.hermitian_eigh_plain(
                    a, bb), iters=3, warmup=1),
                "sweeps_mean": float(taken.float().mean()),
                "sweeps_max": int(taken.max()),
                "bound": _bound(nbytes, _flops_eigh(
                    N, float(taken.sum()), False) + n * _flops_eigh(
                        N, 0, gen)),
                "bound_at_cap": _bound(nbytes, n * _flops_eigh(
                    N, EIGH_SWEEPS, gen))}
            for form in (None,) + es.eigh_forms(N):
                key = "" if form is None else f"{form}_"
                row[f"{key}ms"] = _graph_ms(torch, lambda: es.hermitian_eigh(
                    a, bb, form=form))
                row[f"{key}eager_ms"] = _time_ms(
                    torch, lambda: es.hermitian_eigh(a, bb, form=form))
    lib = {}
    for n in library_counts:
        a, _ = _eigh_inputs(torch, dev, n, N, seed=8, scene=scene)
        try:
            lib[f"n{n}"] = _time_ms(torch, lambda: torch.linalg.eigh(a),
                                    iters=5, warmup=1)
        except RuntimeError as exc:
            lib[f"n{n}"] = f"not measured: {str(exc)[:70]}"
    print(json.dumps({"V1_times_M6": t1, "linalg_eigh_ms": lib}))

    # ---- V2: the per-utterance CLI, on the card against the CPU ----
    v2, v2_launch_total = {}, 0
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        keys = _write_gated_corpus(np, tmp, utts, secs, seed=9)
        for label, extra, want in V2_OPTIONS:
            extra = [str(tmp / "itf.scp") if x == "ITF" else x
                     for x in extra]
            outs, secs_per = {}, {}
            for device in (card, "cpu"):
                out_dir = tmp / f"{label}-{device}"
                argv = [str(tmp / "wav.scp"), str(tmp / "mask.scp"),
                        str(out_dir), "--device", device] + extra
                t0 = time.perf_counter()
                if device == card:
                    _, counts_run = _launched(
                        torch, lambda: cli.run(cli.make_parser().parse_args(
                            argv)), f"V2 {label}", set(want))
                else:
                    cli.run(cli.make_parser().parse_args(argv))
                secs_per[device] = (time.perf_counter() - t0) / utts
                outs[device] = {}
                for key in keys:
                    path = out_dir / f"{key}.wav"
                    if not path.exists():
                        raise AssertionError(f"V2 {label} {device}: {key} "
                                             f"not written")
                    outs[device][key] = read_wav(path, normalize=False)
            if counts_run != {k: c * utts for k, c in want.items()}:
                raise AssertionError(f"V2 {label}: launched {counts_run}, "
                                     f"needs {want} an utterance")
            v2_launch_total += counts_run.get("hermitian_eigh", 0)
            v2[label] = {
                "max_int16_steps": max(float(np.abs(
                    outs[card][k] - outs["cpu"][k]).max()) for k in keys),
                "launches": counts_run,
                "card_s_per_utt": secs_per[card],
                "cpu_s_per_utt": secs_per["cpu"]}
    print(json.dumps({"V2_cli_per_utterance": v2, "utterances": utts,
                      "secs": secs, "tol_steps": 2}))
    for label, row in v2.items():
        if not row["max_int16_steps"] <= 2:
            raise AssertionError(f"V2 {label}: card vs CPU "
                                 f"{row['max_int16_steps']} int16 steps > 2")

    # ---- V3: the batch paths the EVD kernel lifted ----
    v3 = {}
    w_d = torch.from_numpy(gwav16[:v3_b]).to(dev)
    m_d = gmask_d[:v3_b]
    out, c = _launched(torch, lambda: enhance_batch(w_d, m_d, cfg,
                                                    steer="eigh"),
                       "V3 eigh steer", {"stft_covar", "hermitian_eigh",
                                         "beamform_istft"})
    ref = enhance_plain(w_d, m_d, cfg, steer="eigh")
    v3["fused_mvdr_eigh_512_256"] = {"launches": c, "vs_plain": _rel(out,
                                                                     ref)}
    cfg1 = StftConfig(**P1_FIELDS)
    w1, mk1, _ = _gated_scene(v3_b, N, S, seed=1, cfg=cfg1)
    out, c = _launched(torch, lambda: enhance_batch(
        torch.from_numpy(w1).to(dev), torch.from_numpy(mk1).to(dev), cfg1,
        beamformer="gevd"), "V3 gevd 1024/512",
        {"pair_covar", "hermitian_eigh"})
    ref = enhance_batch(w1, mk1, cfg1, beamformer="gevd", device="cpu")
    v3["gevd_1024_512"] = {"launches": c, "vs_cpu": _rel(out.cpu(), ref)}
    out, c = _launched(torch, lambda: enhance_batch(
        w_d, m_d, cfg, beamformer="gevd", chunk_size=V_CHUNK),
        "V3 online gevd", {"masked_covar", "hermitian_eigh"})
    ref = enhance_batch(gwav16[:v3_b], gmask[:v3_b], cfg, beamformer="gevd",
                        chunk_size=V_CHUNK, device="cpu")
    v3["online_gevd_chunk32"] = {"launches": c,
                                 "vs_cpu": _rel(out.cpu(), ref)}
    # WPD at N taps = 132: the scan, its steer through the EVD kernel
    obs = forward_stft(torch.from_numpy(gwav16[:2, :, :WPD_SECS * SR])
                       .float() / 32768, cfg).permute(0, 3, 1, 2)
    obs = obs.contiguous()                          # (2, F, N, T)
    (mask_k, enh_k), c = _launched(torch, lambda: tw.wpd(
        obs, cgmm_iters=WPD_CGMM, wpd_iters=WPD_OUTER, taps=V3_WPD_TAPS,
        device=card), "V3 wpd scan", {"em", "masked_covar",
                                      "hermitian_eigh"})
    mask_p, enh_p = tw.wpd(obs, cgmm_iters=WPD_CGMM, wpd_iters=WPD_OUTER,
                           taps=V3_WPD_TAPS, device="cpu")
    enh_k, mask_k = enh_k.cpu(), mask_k.cpu()
    v3["wpd_scan_taps22"] = {
        "launches": c,
        "enhanced_cosine": float(abs(torch.vdot(
            enh_k.flatten(), enh_p.flatten())) / (
                torch.linalg.vector_norm(enh_k) *
                torch.linalg.vector_norm(enh_p))),
        "mask_corr": float(np.corrcoef(mask_k.numpy().ravel(),
                                       mask_p.numpy().ravel())[0, 1])}
    print(json.dumps({"V3_lifted_paths": v3, "tol": TOL, "wpd_bar": W5_BAR}))
    for label in ("fused_mvdr_eigh_512_256", "gevd_1024_512",
                  "online_gevd_chunk32"):
        err = v3[label].get("vs_plain", v3[label].get("vs_cpu"))
        if not err <= TOL:
            raise AssertionError(f"V3 {label}: {err} > {TOL}")
    if not (v3["wpd_scan_taps22"]["enhanced_cosine"] >= W5_BAR and
            v3["wpd_scan_taps22"]["mask_corr"] >= W5_BAR):
        raise AssertionError(f"V3 wpd: {v3['wpd_scan_taps22']}")

    # the fused mvdr step at the bench width with either steer, and where
    # the eigh steer's step spends its device time
    gwav_d = torch.from_numpy(gwav16).to(dev)
    steps = {steer: _time_ms(torch, lambda: enhance_batch(
        gwav_d, gmask_d, cfg, steer=steer)) for steer in ("eigh", "power")}
    steps["eigh_profile"] = _device_profile(torch, lambda: enhance_batch(
        gwav_d, gmask_d, cfg, steer="eigh"), steps["eigh"])
    print(json.dumps({"V3_fused_mvdr_steps_ms": steps, "B": b}))

    # the kernels line's row: the per-utterance CLI's launch (one
    # utterance's 257 bins, the plain form of mvdr's default steer)
    main = t1[f"n{counts[0]},eigh"]
    launches = v2_launch_total
    row = {
        "name": "hermitian_eigh", "route": "cuda",
        "source": "setk_tpu_torch/csrc/eigh_small.cu",
        "replaces": "none: XLA eigh on the TPU (setk_tpu/ops/linalg.py:27)",
        "launches": launches,
        "max_abs_err": max(r["w_abs_err"] for r in v1.values()),
        "max_rel_err": w_worst, "ms": main["ms"],
        "eager_ms": main["eager_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound"][0], "bound_by": main["bound"][1],
        "library_ms": lib.get(f"n{counts[0]}"),
        "shape": f"{counts[0]} matrices of {N} x {N}, at most "
                 f"{EIGH_SWEEPS} sweeps ({main['sweeps_mean']} taken on "
                 f"average, {main['sweeps_max']} at most), the "
                 f"{main['form']} form",
        "principal_min_cos": cos_worst, "by_count": t1,
        "linalg_eigh_ms_by_count": lib,
        "launches_by_path": {**{f"V2 {k}": r["launches"].get(
            "hermitian_eigh", 0) for k, r in v2.items()},
            **{f"V3 {k}": r["launches"].get("hermitian_eigh", 0)
               for k, r in v3.items()}}}
    return [row], {"V2": v2, "V3": v3, "fused_mvdr_steps_ms": steps}


# ---- the BLSTM mask estimator (kernels 20-21) ----
# MaskNet(arch="blstm") at the train CLI's width (setk_tpu/cli/
# train_mask_estimator.py:114-115: hidden 512, 3 layers, 257 bins) and the
# JAX training bench's batch (benchmarks/bench_training.py:28-34: B = 64,
# T = 400); audio seconds at a hop of 16 ms a frame (bench_training.py)
N_B, N_T, N_F, N_H, N_L = 64, 400, 257, 512, 3
N_HOP_S = 0.016
N_STEPS = 5
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
# kernels 20 and 21 through their resident variants on every MaskNet call
# (bf16 W_h)
LSTM_FWD_SET = {"lstm_seq_forward", "lstm_seq_forward_resident"}
LSTM_SET = LSTM_FWD_SET | {"lstm_seq_backward",
                           "lstm_seq_backward_resident"}
LSTM_FWD_VARIANTS = ("lstm_seq_forward_resident", "lstm_seq_forward_stream")
LSTM_BWD_VARIANTS = ("lstm_seq_backward_resident",
                     "lstm_seq_backward_stream")
# bars, of the peak.  f32: kernels against their plain versions 1e-5 and
# gradients through lstm_seq_bidir against autograd through the plain
# forward 2e-4 (tests/test_pallas_lstm.py:56-80).  bf16 weights, from the
# readings on an NVIDIA H100 80GB HBM3 at 700 W, each about 4-20x under its
# bar: kernel against plain 2e-3 (one bf16 step of a rounded h or dgates
# where two f32 sums of another order straddle a rounding boundary; read
# 5.4e-4); the gradients 1e-2 (kernel 21 rounds dgates before the W_h^T
# product where autograd rounds the product, and dW_h returns in bf16:
# read 4.2e-3); MaskNet's masks against the plain versions 1e-4 (read
# 5.2e-6); 5 Adam steps' losses 1e-5 relative (read 1.8e-7); the CLI
# chain's targets 2e-6 (read 1.2e-7) and masks 2e-4 (read 2.0e-5)
N1_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
N1_GRAD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
N2_TOL = 1e-4
N3_LOSS_RTOL = 1e-5
N4_TARGET_TOL = 2e-6
N4_MASK_TOL = 2e-4


class _PlainLstm:
    """Within the block kernels 20 and 21's wrappers are their plain
    versions: the same call through the plain versions on the card."""

    def __enter__(self):
        from setk_tpu_torch.ops.cuda import lstm_seq as ls
        self.saved = (ls.lstm_seq_forward, ls.lstm_seq_backward)
        ls.lstm_seq_forward = ls.lstm_seq_forward_plain
        ls.lstm_seq_backward = ls.lstm_seq_backward_plain
        return self

    def __exit__(self, *exc):
        from setk_tpu_torch.ops.cuda import lstm_seq as ls
        ls.lstm_seq_forward, ls.lstm_seq_backward = self.saved
        return False


def _lstm_args(np, torch, dev, t, b, h, dtype, seed):
    """Gates (T, B, 4H) f32, W_h (H, 4H) of ``dtype`` and output
    cotangents (T, B, H), numpy-made from ``seed``."""
    rng = np.random.default_rng(seed)
    xg = [torch.from_numpy(rng.standard_normal((t, b, 4 * h)).astype(
        np.float32) * 0.5).to(dev) for _ in "fb"]
    wh = [torch.from_numpy((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                           .astype(np.float32)).to(dev, dtype) for _ in "fb"]
    dy = [torch.from_numpy(rng.standard_normal((t, b, h)).astype(
        np.float32)).to(dev) for _ in "fb"]
    return xg, wh, dy


def _lstm_kernel_errs(torch, xg, wh, dy):
    """Both variants of kernels 20 and 21, each through its own entry
    point, against their plain versions: (relative to the peak, absolute)
    for each, and the plain forward's states."""
    from setk_tpu_torch.ops.cuda import lstm_seq as ls
    ref = ls.lstm_seq_forward_plain(*xg, *wh)
    args = (*dy, *xg, *ref[::2], *ref[1::2], *wh)
    dx_p = ls.lstm_seq_backward_plain(*args)
    rel, abs_ = {}, {}
    for names, run, want in ((LSTM_FWD_VARIANTS, lambda f: f(*xg, *wh), ref),
                             (LSTM_BWD_VARIANTS, lambda f: f(*args), dx_p)):
        for name in names:
            got = run(getattr(ls, name))
            torch.cuda.synchronize()
            rel[name] = max(_rel(g, r) for g, r in zip(got, want))
            abs_[name] = max(_abs(g, r) for g, r in zip(got, want))
    return rel, abs_, ref


def _lstm_grad_errs(torch, xg, wh, dy):
    """dxg_f, dxg_b, dW_h_f, dW_h_b through lstm_seq_bidir (kernels 20-21)
    against autograd through the plain forward: each relative to its
    peak."""
    from setk_tpu_torch.ops.cuda import lstm_seq as ls
    grads = []
    for run in (lambda *a: ls.lstm_seq_bidir(*a),
                lambda *a: ls.lstm_seq_forward_plain(*a)[::2]):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (*xg, *wh)]
        ysf, ysb = run(*leaves)
        ((ysf * dy[0]).sum() + (ysb * dy[1]).sum()).backward()
        grads.append([x.grad.float() for x in leaves])
    return {name: _rel(g, r) for name, g, r in zip(
        ("dxg_f", "dxg_b", "dW_h_f", "dW_h_b"), *grads)}


def _flops_lstm(t, b, h, products):
    """(bf16 recurrent-product FLOP, f32 gate-math FLOP) of one direction
    pair: ``products`` (T B) x (H x 4H) products a direction and ~40 f32
    operations a (t, b, unit) of gate math a pass."""
    return 2 * products * t * b * h * 4 * h * 2, 2 * t * b * h * 40


def _bound_mixed(nbytes, tc_flops, f32_flops):
    """max(bytes over HBM, the products on the bf16 tensor cores plus the
    gate math on the f32 cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tc_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _mask_batch(np, b, t, f, seed):
    """Log-magnitude-like features, targets in [0, 1] and a frame mask of
    utterances from T / 2 to T frames."""
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((b, t, f)) * 2 - 3).astype(np.float32)
    targets = rng.random((b, t, f)).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b)
    lengths[0] = t
    fmask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return feats, targets * fmask[..., None], fmask


def _write_mask_corpus(np, root, count, seed):
    """``count`` mono utterances of 2-5 s (a tone in bursts plus noise) as
    clean and noisy wav files, and their scps."""
    from setk_tpu_torch.io.wave import write_wav
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    clean_lines, noisy_lines = [], []
    for i in range(count):
        s = (2 + i % 4) * SR + 101 * i
        tt = np.arange(s) / SR
        gate = (np.sin(2 * np.pi * 1.5 * tt) > 0).astype(np.float32)
        clean = (0.3 * np.sin(2 * np.pi * (220 + 40 * i) * tt) *
                 gate).astype(np.float32)
        noisy = clean + rng.standard_normal(s).astype(np.float32) * 0.05
        key = f"m{i}"
        write_wav(root / f"{key}.clean.wav", clean, sr=SR)
        write_wav(root / f"{key}.wav", noisy, sr=SR)
        clean_lines.append(f"{key} {root}/{key}.clean.wav")
        noisy_lines.append(f"{key} {root}/{key}.wav")
    (root / "clean.scp").write_text("\n".join(clean_lines) + "\n")
    (root / "noisy.scp").write_text("\n".join(noisy_lines) + "\n")
    return [f"m{i}" for i in range(count)]


def _blstm_slice(np, torch, dev, b=N_B, t=N_T, f=N_F, h=N_H, layers=N_L,
                 steps=N_STEPS, corpus=8):
    """Phases N1-N4 and the timing of kernels 20-21: returns (the kernels
    line's rows for 20-21, a summary of the steps)."""
    from setk_tpu_torch.cli import compute_mask as cm_cli
    from setk_tpu_torch.cli import estimate_nn_masks as est_cli
    from setk_tpu_torch.cli import train_mask_estimator as train_cli
    from setk_tpu_torch.io import ScriptReader
    from setk_tpu_torch.models.mask_net import make_model
    from setk_tpu_torch.models.trainer import MaskTrainer
    from setk_tpu_torch.ops.cuda import _build
    from setk_tpu_torch.ops.cuda import lstm_seq as ls
    bf16, f32 = torch.bfloat16, torch.float32

    # ---- N1: kernels 20 and 21 against their plain versions ----
    n1, n1_abs, picked = {}, {}, {}
    limits = ls.device_limits(dev)
    for label, bb, dtype in ((f"B{b}_f32", b, f32), (f"B{b}_bf16", b, bf16),
                             ("B1_bf16", 1, bf16), ("B6_bf16", 6, bf16),
                             ("B6_f32", 6, f32), ("B1_f32", 1, f32)):
        xg, wh, dy = _lstm_args(np, torch, dev, t, bb, h, dtype, bb)
        n1[label], n1_abs[label], _ = _lstm_kernel_errs(torch, xg, wh, dy)
        picked[label] = [ls.forward_variant(bb, h, dtype, *limits),
                         ls.backward_variant(bb, h, dtype, *limits)]
    n1_grad = {}
    for label, dtype in (("float32", f32), ("bfloat16", bf16)):
        xg, wh, dy = _lstm_args(np, torch, dev, t, b, h, dtype, 7)
        n1_grad[label] = _lstm_grad_errs(torch, xg, wh, dy)
    print(json.dumps({"N1_kernel_vs_plain_rel": n1, "N1_abs": n1_abs,
                      "N1_grad_vs_plain_autograd_rel": n1_grad,
                      "N1_forward_backward_variant": picked,
                      "device_limits": {"sms": limits[0],
                                        "smem_optin": limits[1]},
                      "tol": N1_TOL, "grad_tol": N1_GRAD_TOL}))
    if {v for pair in picked.values() for v in pair} != {"resident"}:
        raise AssertionError(f"N1: the gates pick {picked}, need the "
                             f"resident variants at every N1 shape")
    for label, errs in n1.items():
        key = "float32" if label.endswith("f32") else "bfloat16"
        for name, err in errs.items():
            if not err <= N1_TOL[key]:
                raise AssertionError(f"N1 {label} {name}: kernel vs plain "
                                     f"{err} > {N1_TOL[key]}")
    for key, errs in n1_grad.items():
        for name, err in errs.items():
            if not err <= N1_GRAD_TOL[key]:
                raise AssertionError(
                    f"N1 {key} {name}: lstm_seq_bidir vs autograd "
                    f"through the plain forward {err} > {N1_GRAD_TOL[key]}")

    # ---- N2: MaskNet blstm forward at full width ----
    feats, targets, fmask = _mask_batch(np, b, t, f, 11)
    feats_d = torch.from_numpy(feats).to(dev)
    model = make_model("blstm", f, h, layers)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev)
    with torch.no_grad():
        masks, counts = _launched(torch, lambda: model(feats_d), "N2",
                                  LSTM_FWD_SET)
        with _PlainLstm():
            masks_p = model(feats_d)
    n2_err = _abs(masks, masks_p)
    print(json.dumps({"N2_masknet_launches": counts,
                      "N2_mask_vs_plain_max_abs": n2_err, "tol": N2_TOL}))
    if counts != dict.fromkeys(LSTM_FWD_SET, layers) or not torch.isfinite(
            masks).all() or tuple(masks.shape) != (b, t, f) or \
            not n2_err <= N2_TOL:
        raise AssertionError(f"N2: launches {counts}, masks "
                             f"{tuple(masks.shape)} vs plain {n2_err}")

    # ---- N3: MaskTrainer steps against the plain path from one init ----
    trainer = MaskTrainer(make_model("blstm", f, h, layers), seed=0,
                          device=dev)
    plain = MaskTrainer(make_model("blstm", f, h, layers), seed=1,
                        device=dev)
    plain.model.load_state_dict(trainer.model.state_dict())
    losses, losses_p, n3_counts = [], [], []
    for _ in range(steps):
        loss, counts = _launched(torch, lambda: trainer.train_batch(
            feats, targets, fmask), "N3 step", LSTM_SET)
        n3_counts.append(counts)
        losses.append(loss)
        with _PlainLstm():
            losses_p.append(plain.train_batch(feats, targets, fmask))
    n3_err = max(abs(a - p) / abs(p) for a, p in zip(losses, losses_p))
    train_launches = {k: sum(c.get(k, 0) for c in n3_counts)
                      for k in sorted(LSTM_SET)}
    print(json.dumps({"N3_losses": losses, "N3_plain_losses": losses_p,
                      "N3_loss_rel_err": n3_err, "tol": N3_LOSS_RTOL,
                      "N3_launches": train_launches}))
    if any(c != dict.fromkeys(LSTM_SET, layers) for c in n3_counts) or \
            not np.isfinite(losses).all() or not n3_err <= N3_LOSS_RTOL:
        raise AssertionError(f"N3: launches {n3_counts}, losses {losses} "
                             f"vs plain {losses_p}")

    # ---- N4: the recipe's CLI chain, on the card against --device cpu ----
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        keys = _write_mask_corpus(np, tmp, corpus, seed=5)
        targets_by = {}
        for device in ("cuda", "cpu"):
            argv = [str(tmp / "clean.scp"), str(tmp / "noisy.scp"),
                    str(tmp / f"target-{device}.ark"), "--scp",
                    str(tmp / f"target-{device}.scp"), "--device", device]
            cm_cli.run(cm_cli.make_parser().parse_args(argv))
            targets_by[device] = ScriptReader(str(tmp / f"target-{device}"
                                                  f".scp"))
        n4_target = max(float(np.abs(targets_by["cuda"][k] -
                                     targets_by["cpu"][k]).max())
                        for k in keys)
        ckpt = tmp / "final.msgpack"
        argv = [str(tmp / "noisy.scp"), str(tmp / "target-cuda.scp"),
                str(ckpt), "--arch", "blstm", "--hidden", str(h),
                "--num-layers", str(layers), "--epochs", "2",
                "--batch-size", "8", "--device", "cuda"]
        _, train_counts = _launched(torch, lambda: train_cli.run(
            train_cli.make_parser().parse_args(argv)), "N4 train", LSTM_SET)
        batches = 2 * -(-corpus // 8)
        masks_by = {}
        for device in ("cuda", "cpu"):
            out = tmp / f"masks-{device}"
            argv = [str(tmp / "noisy.scp"), str(ckpt), str(out), "--device",
                    device]
            run = (lambda: est_cli.run(est_cli.make_parser().parse_args(
                argv)))
            if device == "cuda":
                _, est_counts = _launched(torch, run, "N4 estimate",
                                          LSTM_FWD_SET)
            else:
                run()
            masks_by[device] = {k: np.load(out / f"{k}.npy") for k in keys}
        n4_mask = max(float(np.abs(masks_by["cuda"][k] -
                                   masks_by["cpu"][k]).max()) for k in keys)
    want_train = dict.fromkeys(LSTM_SET, layers * batches)
    print(json.dumps({"N4_target_card_vs_cpu_max_abs": n4_target,
                      "N4_mask_card_vs_cpu_max_abs": n4_mask,
                      "tol": [N4_TARGET_TOL, N4_MASK_TOL],
                      "N4_train_launches": train_counts,
                      "N4_estimate_launches": est_counts,
                      "utterances": corpus}))
    if train_counts != want_train or est_counts != dict.fromkeys(
            LSTM_FWD_SET, layers * corpus) or \
            not n4_target <= N4_TARGET_TOL or not n4_mask <= N4_MASK_TOL or \
            not all(np.isfinite(m).all() for m in masks_by["cuda"].values()):
        raise AssertionError(f"N4: train launches {train_counts}, estimate "
                             f"{est_counts}, targets {n4_target}, masks "
                             f"{n4_mask}")

    # ---- timing: kernels 20-21 at the bench shape, bf16 weights ----
    xg, wh, dy = _lstm_args(np, torch, dev, t, b, h, bf16, b)
    states = ls.lstm_seq_forward_plain(*xg, *wh)
    bargs = (*dy, *xg, *states[::2], *states[1::2], *wh)
    seq, gate = t * b * h * 4, t * b * 4 * h * 4   # bytes of (T, B, H|4H)
    w_bytes = 2 * h * 4 * h * 2
    tc1, f1 = _flops_lstm(t, b, h, 1)
    tc2, f2 = _flops_lstm(t, b, h, 2)
    rows = [
        ("lstm_seq_forward", "setk_tpu/ops/pallas/lstm_seq.py:130",
         lambda: ls.lstm_seq_forward(*xg, *wh),
         lambda: ls.lstm_seq_forward_plain(*xg, *wh),
         _bound_mixed(2 * gate + w_bytes + 4 * seq, tc1, f1)),
        ("lstm_seq_backward", "setk_tpu/ops/pallas/lstm_seq.py:159",
         lambda: ls.lstm_seq_backward(*bargs),
         lambda: ls.lstm_seq_backward_plain(*bargs),
         _bound_mixed(4 * gate + w_bytes + 6 * seq, tc2, f2 * 2))]
    # for information only, never called by the port: cuDNN's
    # bidirectional LSTM at the same (T, B, H) over a layer's 2H-wide input
    # (it also runs the input projection), f32 as the port's projections;
    # the forward as training runs it and as inference runs it, forward and
    # backward, and the backward alone (the forward outside the timed
    # window): the input's gradient alone, and with the weights' as a
    # training step takes them
    cudnn = torch.nn.LSTM(2 * h, h, bidirectional=True).to(dev)
    x_in = torch.randn(t, b, 2 * h, device=dev, requires_grad=True)
    info = {"lstm_seq_forward": _time_ms(torch, lambda: cudnn(x_in)[0],
                                         iters=5),
            "lstm_seq_backward": _time_ms(
                torch, lambda: cudnn(x_in)[0].sum().backward(), iters=5)}
    with torch.no_grad():
        cudnn_inference_ms = _time_ms(torch, lambda: cudnn(x_in)[0], iters=5)
    y_in = cudnn(x_in)[0]
    g_in = torch.randn_like(y_in)
    cudnn_bwd = {
        "cudnn_lstm_bidir_bwd_ms_info": _time_ms(
            torch, lambda: torch.autograd.grad(
                y_in, [x_in, *cudnn.parameters()], g_in, retain_graph=True),
            iters=5),
        "cudnn_lstm_bidir_bwd_data_ms_info": _time_ms(
            torch, lambda: torch.autograd.grad(y_in, x_in, g_in,
                                               retain_graph=True), iters=5)}
    del y_in, g_in
    launches = dict(train_launches)
    abs_errs = n1_abs[f"B{b}_bf16"]
    rel_errs = n1[f"B{b}_bf16"]
    # each row is its kernel's resident variant, which every MaskNet call
    # takes; the stream variant's time and error beside it
    row_of = {"lstm_seq_forward": "lstm_seq_forward_resident",
              "lstm_seq_backward": "lstm_seq_backward_resident"}
    stream_of = {"lstm_seq_forward": (
        "lstm_seq_forward_stream", lambda: ls.lstm_seq_forward_stream(
            *xg, *wh)), "lstm_seq_backward": (
        "lstm_seq_backward_stream", lambda: ls.lstm_seq_backward_stream(
            *bargs))}
    kernels = []
    for name, replaces, run_k, run_p, (bound_ms, bound_by) in rows:
        key = row_of[name]
        row = {
            "name": name, "route": "cuda",
            "source": "setk_tpu_torch/csrc/lstm_seq.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": abs_errs[key], "max_rel_err": rel_errs[key],
            "ms": _graph_ms(torch, run_k, iters=5),
            "eager_ms": _time_ms(torch, run_k, iters=5, warmup=1),
            "plain_ms": _time_ms(torch, run_p, iters=2, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "peaks": "bf16 products 989 TFLOP/s, gate math 67 TFLOP/s f32",
            "library_ms": None,
            "cudnn_lstm_bidir_ms_info" if name.endswith("forward") else
            "cudnn_lstm_bidir_fwd_bwd_ms_info": info[name]}
        stream, run_s = stream_of[name]
        row.update({"variant": "resident",
                    "stream_ms": _graph_ms(torch, run_s, iters=5),
                    "stream_max_abs_err": abs_errs[stream]})
        row.update({"cudnn_lstm_bidir_inference_ms_info": cudnn_inference_ms}
                   if name == "lstm_seq_forward" else cudnn_bwd)
        kernels.append(row)
    # the resident variants' latency floor: one step's barrier and
    # bookkeeping at H = 8, B = 1, which the byte bound does not show; and
    # B = 1 at the full width, as estimate_nn_masks serves (kernel 20) and
    # a one-utterance batch trains (kernel 21)
    floor, bfloor = {}, {}
    for label, bb, hh in (("H8_B1", 1, 8), (f"H{h}_B1", 1, h)):
        xg1, wh1, dy1 = _lstm_args(np, torch, dev, t, bb, hh, bf16, 3)
        ms = _graph_ms(torch, lambda: ls.lstm_seq_forward_resident(
            *xg1, *wh1), iters=5)
        floor[label] = {"T": t, "B": bb, "H": hh, "ms": ms,
                        "us_per_step": ms * 1e3 / t}
        st1 = ls.lstm_seq_forward_plain(*xg1, *wh1)
        a1 = (*dy1, *xg1, *st1[::2], *st1[1::2], *wh1)
        ms = _graph_ms(torch, lambda: ls.lstm_seq_backward_resident(*a1),
                       iters=5)
        bfloor[label] = {"T": t, "B": bb, "H": hh, "ms": ms,
                         "us_per_step": ms * 1e3 / t}
    print(json.dumps({"lstm_fwd_resident_floor": floor,
                      "lstm_bwd_resident_floor": bfloor,
                      "lstm_fwd_resident_layout_bench": dict(zip(
                          ("blocks_per_direction", "units_per_block",
                           "h_tile_stride", "h_tile_rows", "smem_bytes"),
                          ls.resident_layout(b, h, 2, *limits))),
                      "lstm_bwd_resident_layout_bench": dict(zip(
                          ("blocks_per_direction", "units_per_block",
                           "phase1_rows", "phase1_stride", "phase2_rows",
                           "phase2_chunk", "phase2_stride", "smem_bytes"),
                          ls.backward_resident_layout(b, h, 2, *limits)))}))

    # ---- the serving and training steps ----
    audio_s = b * t * N_HOP_S
    one = feats_d[:1]
    steps = {}
    with torch.no_grad():
        serve_ms = _time_ms(torch, lambda: model(feats_d), iters=5)
        steps[f"serve_B{b}_T{t}"] = {
            "ms": serve_ms, "audio_s_per_s": audio_s / (serve_ms / 1e3),
            "profile": _device_profile(torch, lambda: model(feats_d),
                                       serve_ms, iters=3)}
        one_ms = _time_ms(torch, lambda: model(one), iters=5)
        steps[f"serve_B1_T{t}"] = {
            "ms": one_ms, "audio_s_per_s": t * N_HOP_S / (one_ms / 1e3)}
        with _PlainLstm():
            steps["serve_plain_ms"] = _time_ms(torch, lambda: model(feats_d),
                                               iters=2, warmup=1)
    train_ms = _time_ms(torch, lambda: trainer.train_batch(
        feats, targets, fmask), iters=3, warmup=1)
    steps[f"train_B{b}_T{t}"] = {
        "ms": train_ms, "audio_s_per_s": audio_s / (train_ms / 1e3),
        "profile": _device_profile(torch, lambda: trainer.train_batch(
            feats, targets, fmask), train_ms, iters=2)}
    with _PlainLstm():
        steps["train_plain_ms"] = _time_ms(torch, lambda: plain.train_batch(
            feats, targets, fmask), iters=2, warmup=1)
    print(json.dumps({"blstm_steps": steps}))
    return kernels, steps


def _run_clusterer(clusterer, utts):
    results = {}
    for key, obs in utts.items():
        results.update(clusterer.add(key, obs))
    results.update(clusterer.flush())
    return results


def _run_enhancer(enhancer, utts):
    results = {}
    for key, (x, m, _) in utts.items():
        results.update(enhancer.add(key, x, m))
    results.update(enhancer.flush())
    return results


def _say(message: str) -> None:
    """One line on stdout and on stderr."""
    print(message)
    print(message, file=sys.stderr)


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "setk_tpu_torch" / "csrc").is_dir():
        _say(f"chip_smoke: exit 2, no setk_tpu_torch/csrc beside this "
             f"script under {root}")
        return 2
    import torch
    if not torch.cuda.is_available():
        _say(f"chip_smoke: exit 2, no CUDA device (torch "
             f"{torch.__version__}, CUDA {torch.version.cuda}, "
             f"{torch.cuda.device_count()} devices)")
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
    ptxas = _ptxas_summary("\n".join(logs.values()))
    print(json.dumps({"ptxas": ptxas}))
    # kernel 15 at the recipes' M = 6, K = 2: registers, stack and spills
    print(json.dumps({"ptxas_em_warp<6,2>": ptxas.get("em_warp<6,2>",
                                                      "not built now")}))
    # kernel A at the bench's N = 6 and at N = 8, with its layout there
    print(json.dumps({"ptxas_stft_covar": {
        key: ptxas.get(key, "not built now") for key in (
            "stft_covar<6,int16>", "stft_covar<6,f32>",
            "stft_covar<8,int16>", "stft_covar<8,f32>")},
        "layout": {n: fm.kernel_a_layout(n, True, torch.device("cuda", 0))
                   for n in (6, 8)}}))
    # kernel B the same, with its runs an utterance at the bench's B and S
    print(json.dumps({"ptxas_beamform_istft": {
        key: ptxas.get(key, "not built now") for key in (
            "beamform_istft<6,int16>", "beamform_istft<6,f32>",
            "beamform_istft<8,int16>", "beamform_istft<8,f32>",
            "beamform_istft_online<6,int16>")},
        "layout": {f"{n},{'online' if on else 'offline'}": fm.kernel_b_layout(
            n, True, on, B, S, torch.device("cuda", 0))
            for n in (6, 8) for on in (False, True)}}))

    # kernel 9's instances at each n_fft
    print(json.dumps({"ptxas_stft_planar": {
        key: ptxas.get(key, "not built now") for key in (
            f"stft_planar<{lg},{c},{t}>" for lg in (8, 9, 10, 11)
            for c in (1, 0) for t in ("int16", "f32"))}}))
    # kernel 10's at each n_fft, without (0) and with (1) the beamform
    print(json.dumps({"ptxas_istft_planar": {
        key: ptxas.get(key, "not built now") for key in (
            f"istft_planar<{lg},{bf}>" for lg in (8, 9, 10, 11)
            for bf in (0, 1))}}))

    # the EVD kernel at every M, plain (0) and generalized (1), a thread
    # and a lane group a matrix
    print(json.dumps({"ptxas_hermitian_eigh": {
        key: ptxas.get(key, "not built now") for key in (
            f"hermitian_eigh{form}<{m},{g}>" for form in ("", "_lanes")
            for m in range(1, 9) for g in (0, 1))}}))

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
    print(json.dumps({"kernel_a_other_shapes_max_rel_err":
                      _kernel_a_shapes(np, torch, dev, window, fm),
                      "tol": TOL}))
    print(json.dumps({"kernel_b_other_shapes_max_rel_err":
                      _kernel_b_shapes(np, torch, dev, window, fm),
                      "tol": TOL}))

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
        PLANAR_SET - {"beamform_istft_planar"})
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
    p2_errs, p2_abs, p2 = _planar_kernels(torch, dev, wav2_d, mask2_d, cfg)
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
    for label, kw in (("N=9", {}), ("N=9 gevd", {"beamformer": "gevd"})):
        try:
            enhance_batch(wav9, mask_e[:2], cfg_e, **kw)
        except NotImplementedError as exc:
            refused[label] = re.search(r"ROADMAP [^;,]*", str(exc)).group(0)
        else:
            raise AssertionError(f"E {label} was not refused")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("a refusal allocated device memory")
    print(json.dumps({"E_refusals": refused}))

    # ---- 13. C1: the clustering kernels against their plain versions ----
    from setk_tpu_torch.enhance.cluster import (_uniform_init, cacgmm_em,
                                                cgmm_em, norm_observation)
    from setk_tpu_torch.ops.cuda import cacgmm_em as ce
    from setk_tpu_torch.ops.cuda import covariance as mc
    from setk_tpu_torch.ops.cuda import eigh_small as es
    from setk_tpu_torch.parallel.executor import BatchClusterer
    f_bins = cfg.num_bins
    obs_np = forward_stft(gwav_d.float() / 32768.0, cfg).permute(
        0, 3, 1, 2).cpu().numpy()                        # (B, F, N, T)
    bucket = -(-t_frames // CL_BUCKET) * CL_BUCKET
    cobs_np, cfm_np = _cluster_batch(np, list(obs_np), bucket)
    cobs = torch.from_numpy(cobs_np).to(dev)
    cfm = torch.from_numpy(cfm_np).to(dev)
    # kernel 13 on the scan's K=2 weights gamma fm M / phi after 4
    # iterations, kernel 14 on the covariances they give
    g4, _, st4 = cgmm_em(cobs, 2, num_iters=CL_CHECK_ITERS, frame_mask=cfm,
                         return_state=True)
    w13 = (g4 * cfm * N / st4["phi"]).contiguous()
    num_k = mc.masked_covar(cobs, w13)
    num_p = mc.masked_covar_plain(cobs, w13)
    den13 = torch.clamp((g4 * cfm).sum(-1), min=1.1920929e-07)
    cov13 = (num_p / den13[..., None, None]).contiguous()
    inv_k, ld_k = es.regularized_inverse(cov13)
    inv_p, ld_p = es.jacobi_regularized_inverse_plain(cov13)
    peak14 = inv_p.abs().amax(dim=(-1, -2))
    cl_errs = {"masked_covar": _rel(num_k, num_p),
               "regularized_inverse": float(((inv_k - inv_p).abs().amax(
                   dim=(-1, -2)) / peak14).max()),
               "regularized_inverse_logdet": _abs(ld_k, ld_p)}
    cl_abs = {"masked_covar": _abs(num_k, num_p),
              "regularized_inverse": max(_abs(inv_k, inv_p),
                                         _abs(ld_k, ld_p))}
    print(json.dumps({"C1_kernel_vs_plain": cl_errs, "T": t_frames,
                      "bucket": bucket, "tol": TOL}))
    for name in ("masked_covar", "regularized_inverse"):
        if not cl_errs[name] <= TOL:
            raise AssertionError(f"C1 {name}: kernel vs plain "
                                 f"{cl_errs[name]} > {TOL}")
    # kernel 15 at 4 iterations, both models, both entries, K = 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    nobs = norm_observation(cobs, axis=-2)
    g0 = _uniform_init(2, (B, f_bins, bucket), cobs, gen)
    b3 = min(16, B)
    g3 = _uniform_init(3, (b3, f_bins, bucket), cobs, gen)
    # WPD's CGMM shape (B = 32 x 4 s, T = 251, no frame mask): the first
    # 251 frames; M = 8, K = 4 at B = 4: each utterance's 6 mics and the
    # first 2 of the next one's
    b8 = min(4, B - 1)
    obs8 = norm_observation(torch.cat(
        [cobs[:b8], cobs[1:b8 + 1, :, :2]], dim=-2), axis=-2)
    g8 = _uniform_init(4, (b8, f_bins, bucket), cobs, gen)
    em_cases = {
        "cgmm_higuchi": (cobs, None, None, "cg", False, "higuchi", 2),
        "cacgmm_operand": (nobs, g0, torch.ones_like(g0), "cacg", True,
                           None, 2),
        "cacgmm_higuchi": (nobs, None, None, "cacg", True, "higuchi", 2),
        "cacgmm_k3_b16": (nobs[:b3].contiguous(), g3, torch.ones_like(g3),
                          "cacg", True, None, 3),
        "cgmm_wpd_shape": (cobs[:W_B, ..., :WPD_T].contiguous(), None, None,
                           "cg", False, "higuchi", 2),
        "cacgmm_m8_k4_b4": (obs8, g8, torch.ones_like(g8), "cacg", True,
                            None, 4)}
    em_errs = {}
    for label, (o, ga, ka, model, upd, init, k) in em_cases.items():
        fm_k = None if o.shape[-1] != bucket else cfm[:o.shape[0]]
        kw = dict(frame_mask=fm_k, return_state=True, init=init,
                  num_classes=k)
        em_errs[label] = _em_errs(
            torch, ce.em(o, ga, ka, CL_CHECK_ITERS, model, upd, **kw),
            ce.em_plain(o, ga, ka, CL_CHECK_ITERS, model, upd, **kw))
    torch.cuda.synchronize()
    print(json.dumps({"C1_em_vs_plain": em_errs, "iters": CL_CHECK_ITERS,
                      "bars": EM_BARS}))
    for label, err in em_errs.items():
        if not (err["gamma"] <= EM_BARS["gamma"] and
                err["q_over_bar"] <= EM_BARS["q_atol"] and
                err["alpha"] <= EM_BARS["alpha"] and
                err["covar"] <= EM_BARS["covar"]):
            raise AssertionError(f"C1 em {label}: {err} outside {EM_BARS}")

    # ---- 14. C2: BatchClusterer on the card ----
    cl_utts = {f"c{i:03d}": obs_np[i] for i in range(B)}
    for i, t_len in enumerate((300, 330, 200, 250)):   # buckets 384, 256
        cl_utts[f"d{i}"] = np.ascontiguousarray(
            obs_np[(i + 7) % B][..., :t_len])
    cl_path = {}
    for algo in ("cgmm", "cacgmm"):
        clusterer = BatchClusterer(algo=algo, num_iters=CL_ITERS,
                                   batch_size=B, device="cuda")
        t0 = time.perf_counter()
        res, counts = _launched(torch, lambda: _run_clusterer(clusterer,
                                                              cl_utts),
                                f"BatchClusterer {algo}", EM_SET)
        secs = time.perf_counter() - t0
        if set(res) != set(cl_utts):
            raise AssertionError(f"BatchClusterer {algo} lost utterances")
        sum_err = 0.0
        for key, gamma in res.items():
            if gamma.shape != (2, f_bins, cl_utts[key].shape[-1]) or \
                    not np.isfinite(gamma).all() or gamma.min() < 0 or \
                    gamma.max() > 1:
                raise AssertionError(f"{algo} {key}: bad masks {gamma.shape}")
            sum_err = max(sum_err, float(np.abs(gamma.sum(0) - 1).max()))
        # the plain path on the card, bucket by bucket
        buckets = {}
        for key, o in cl_utts.items():
            buckets.setdefault(-(-o.shape[-1] // CL_BUCKET) * CL_BUCKET,
                               []).append(key)
        got_all, ref_all, worst = [], [], 0.0
        for bk, keys in buckets.items():
            ob, fb = _cluster_batch(np, [cl_utts[k] for k in keys], bk)
            ref, _ = _cluster_plain(torch, algo, torch.from_numpy(ob).to(dev),
                                    torch.from_numpy(fb).to(dev), CL_ITERS, 0)
            ref = ref.cpu().numpy()
            for i, key in enumerate(keys):
                t_len = cl_utts[key].shape[-1]
                got_all.append(res[key].ravel())
                ref_all.append(ref[:, i, :, :t_len].ravel())
                worst = max(worst, float(np.abs(got_all[-1] -
                                                ref_all[-1]).max()))
        corr = float(np.corrcoef(np.concatenate(got_all),
                                 np.concatenate(ref_all))[0, 1])
        # the 512 bucket's Q history: the entry itself against plain
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        entry = cgmm_em if algo == "cgmm" else cacgmm_em
        _, q_k = entry(cobs, 2, num_iters=CL_ITERS, frame_mask=cfm,
                       generator=gen)
        _, q_p = _cluster_plain(torch, algo, cobs, cfm, CL_ITERS, 0)
        q_rel = float(((q_k - q_p).abs() / q_p.abs()).max())
        cl_path[algo] = {"launches": counts, "seconds": secs,
                         "buckets": sorted(buckets),
                         "max_abs_sum_minus_1": sum_err,
                         "vs_plain_max_abs": worst, "vs_plain_corr": corr,
                         "q_rel_err": q_rel, "q_last": float(q_k[-1])}
        if not corr >= 0.9999:
            raise AssertionError(f"BatchClusterer {algo}: mask correlation "
                                 f"with the plain path {corr} < 0.9999")
        if not q_rel <= 2e-3 or not sum_err <= 1e-4:
            raise AssertionError(f"BatchClusterer {algo}: {cl_path[algo]}")
    print(json.dumps({"C2_BatchClusterer": cl_path, "iters": CL_ITERS}))

    # ---- 15. C3: the clustering CLIs on the card against the CPU ----
    from setk_tpu_torch.cli import estimate_cgmm_masks as cgmm_cli
    cl_cli = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        keys = _write_corpus(tmp, seed=3)
        scp = str(tmp / "wav.scp")

        def cgmm(*argv):
            cgmm_cli.run(cgmm_cli.make_parser().parse_args([scp, *argv]))

        masks = {}
        for label, argv, want in (
                ("batched", ["--batch-size", "4"], EM_SET),
                ("dump", ["--dump-model", "{mdl}"], EM_SET),
                ("resume", ["--resume-model", "{mdl}", "--num-iters",
                            str(CL_RESUME_ITERS)],
                 {"masked_covar", "regularized_inverse"})):
            for device in ("cuda", "cpu"):
                out = tmp / f"{label}-{device}"
                args = [str(out), "--device", device, "--scp",
                        f"{out}.scp"] + [a.format(mdl=tmp / f"mdl-{device}")
                                         for a in argv]
                if device == "cuda":
                    _, counts = _launched(torch, lambda: cgmm(*args),
                                          f"CGMM CLI {label}", want)
                    cl_cli.setdefault(label, {})["launches"] = counts
                else:
                    cgmm(*args)
                masks[label, device] = {k: np.load(out / f"{k}.npy")
                                        for k in keys}
            cl_cli[label]["card_vs_cpu_max_abs"] = max(
                float(np.abs(masks[label, "cuda"][k] -
                             masks[label, "cpu"][k]).max()) for k in keys)
        want_resume = {"masked_covar": len(keys) * CL_RESUME_ITERS,
                       "regularized_inverse": len(keys) * (
                           CL_RESUME_ITERS + 1)}
        if cl_cli["resume"]["launches"] != want_resume:
            raise AssertionError(f"CGMM CLI resume launched "
                                 f"{cl_cli['resume']['launches']}, needs "
                                 f"{want_resume}")
        # the recipe's chain: the card's masks into the beamformer
        from setk_tpu_torch.cli import apply_adaptive_beamformer as bf_cli
        from setk_tpu_torch.io.wave import read_wav
        enh = tmp / "enhanced"
        _, cl_cli["chain_launches"] = _launched(
            torch, lambda: bf_cli.run(bf_cli.make_parser().parse_args(
                [scp, str(tmp / "batched-cuda.scp"), str(enh),
                 "--batch-size", "4"])), "CGMM masks -> beamformer",
            FUSED_SET)
        for key in keys:
            if not (enh / f"{key}.wav").exists() or not np.isfinite(
                    read_wav(enh / f"{key}.wav", normalize=False)).all():
                raise AssertionError(f"chain: {key} missing or not finite")
    print(json.dumps({"C3_clustering_cli": cl_cli, "utterances": len(keys),
                      "tol": 2e-3}))
    for label in ("batched", "dump", "resume"):
        if not cl_cli[label]["card_vs_cpu_max_abs"] <= 2e-3:
            raise AssertionError(f"CGMM CLI {label}: card vs CPU "
                                 f"{cl_cli[label]} > 2e-3")

    # ---- 16. C4: clustering refusals before any device allocation ----
    cl_refused = {}
    before = torch.cuda.memory_allocated()
    try:
        BatchClusterer(algo="cgmm", batch_size=1, device="cuda").add(
            "m9", np.zeros((f_bins, 9, 100), np.complex64))
    except NotImplementedError as exc:
        cl_refused["M=9"] = re.search(r"ROADMAP [^;,]*", str(exc)).group(0)
    try:
        cacgmm_em(np.zeros((f_bins, N, 100), np.complex64), 2, num_iters=0,
                  device="cuda")
    except ValueError as exc:
        cl_refused["num_iters=0"] = str(exc)
    if len(cl_refused) != 2 or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"clustering refusals {cl_refused}, memory "
                             f"{before} -> {torch.cuda.memory_allocated()}")
    print(json.dumps({"C4_refusals": cl_refused}))

    # ---- 17. W1-W5: WPE dereverberation and factored WPD ----
    wpe_kernels, wpe_steps = _wpe_slice(np, torch, dev, cfg)

    # ---- 18. N1-N4: the BLSTM mask estimator ----
    blstm_kernels, blstm_steps = _blstm_slice(np, torch, dev)

    # ---- 19. V1-V3: the Hermitian EVD and the per-utterance CLI ----
    evd_kernels, evd_steps = _evd_slice(np, torch, dev)

    # ---- 20. timing at the bench shape ----
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
    # for information only (the port never calls these; they are not the
    # same function, so library_ms stays null): torch.linalg.solve on the
    # same systems, and for kernel A one torch.fft.rfft of the framed,
    # windowed audio (its transforms alone, no covariance formed)
    info = {"stft_covar": rfft_ms, "stft_covar_chunks": rfft_ms,
            "pmwf_solve": _time_ms(torch, lambda: torch.linalg.solve(grn,
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
        ("beamform_istft_planar", "setk_tpu/ops/pallas/stft.py:300",
         lambda: pl.beamform_istft_planar(*p1["planes"], p1["w"],
                                          p1["window"], p1["wss"], S),
         lambda: pl.beamform_istft_planar_plain(*p1["planes"], p1["w"],
                                                p1["window"], p1["wss"], S),
         _bound(sum(x.nbytes for x in p1["planes"]) + p1["w"].nbytes +
                p1["wss"].nbytes + p1["out_w"].nbytes,
                _flops_beamform_istft_planar(B, N, t1, cfg1.n_fft))),
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
                    istft_planar=p1_be_launches.get("istft_planar", 0),
                    beamform_istft_planar=p1_be_launches[
                        "beamform_istft_planar"],
                    pair_covar=e_path["mvdr+ban"]["launches"]["pair_covar"])
    errs.update(p1_errs, pair_covar=e_errs["random_mask_n"])
    abs_errs.update(p1_abs, pair_covar=e_abs["random_mask_n"])
    source.update(stft_planar="setk_tpu_torch/csrc/planar_stft.cu",
                  istft_planar="setk_tpu_torch/csrc/planar_stft.cu",
                  beamform_istft_planar="setk_tpu_torch/csrc/planar_stft.cu",
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
    # the clustering kernels at C1's shapes (B=128, T = 512 bucket, K = 2)
    n_mat = cov13.numel() // (N * N)
    em_run = (lambda: ce.em(cobs, None, None, CL_ITERS, "cg", False,
                            frame_mask=cfm, init="higuchi"))
    em_plain_run = (lambda: ce.em_plain(cobs, None, None, CL_ITERS, "cg",
                                        False, frame_mask=cfm,
                                        init="higuchi"))
    em_out = em_run()
    rows += [
        ("masked_covar", "setk_tpu/ops/pallas/covariance.py:46",
         lambda: mc.masked_covar(cobs, w13),
         lambda: mc.masked_covar_plain(cobs, w13),
         _bound(cobs.nbytes + w13.nbytes + num_k.nbytes,
                _flops_masked_covar(B * f_bins, N, bucket, 2))),
        ("regularized_inverse", "setk_tpu/ops/pallas/eigh_small.py:183",
         lambda: es.regularized_inverse(cov13),
         lambda: es.jacobi_regularized_inverse_plain(cov13),
         _bound(cov13.nbytes + inv_k.nbytes + ld_k.nbytes,
                n_mat * _flops_jacobi(N, CL_SWEEPS))),
        ("em", "setk_tpu/ops/pallas/cacgmm_em.py:301", em_run, em_plain_run,
         _bound(cobs.nbytes + cfm.nbytes + em_out[0].nbytes +
                em_out[1].nbytes,
                _flops_em(B * f_bins, N, bucket, 2, CL_ITERS, CL_SWEEPS))),
    ]
    # kernel 15's launches: the cgmm BatchClusterer run of C2 (one a
    # bucket); kernels 13 and 14: the CLI's per-utterance resume of C3
    launches.update(em=cl_path["cgmm"]["launches"]["em"],
                    **cl_cli["resume"]["launches"])
    errs.update(masked_covar=cl_errs["masked_covar"],
                regularized_inverse=cl_errs["regularized_inverse"],
                em=max(e["gamma"] for e in em_errs.values()))
    abs_errs.update(cl_abs, em=max(max(e["gamma"], e["q_abs"], e["alpha"])
                                   for e in em_errs.values()))
    source.update(masked_covar="setk_tpu_torch/csrc/covariance.cu",
                  regularized_inverse="setk_tpu_torch/csrc/eigh_small.cu",
                  em="setk_tpu_torch/csrc/cacgmm_em.cu")
    # the JAX package's N > 8 formula: one einsum over the K-fold
    # broadcast of the weighted observations (timed, never called)
    library["masked_covar"] = _time_ms(torch, lambda: torch.einsum(
        "...nt,...mt->...nm", w13[..., None, :] * cobs[None], cobs.conj()),
        iters=5)
    # for information only: a batched complex EVD of the same matrices,
    # not the same function (the floor, the inverse and the logdet follow);
    # cuSOLVER's batched solver has refused all 65,792 matrices at once,
    # so smaller leading batches are tried
    flat13 = cov13.reshape(-1, N, N)
    for count in (flat13.shape[0], 32768, 16384):
        try:
            info["regularized_inverse"] = {"matrices": count, "ms": _time_ms(
                torch, lambda: torch.linalg.eigh(flat13[:count]), iters=5,
                warmup=1)}
            break
        except RuntimeError as exc:
            info["regularized_inverse"] = f"not measured: {str(exc)[:70]}"
    # kernel 14 at the CGMM CLI resume's launch (one utterance's K = 2 x
    # 257 matrices, as C3 launches it 36 times)
    res14 = cov13[:, 0].contiguous()
    inv_r, _ = es.regularized_inverse(res14)
    inv_rp, _ = es.jacobi_regularized_inverse_plain(res14)
    res14_err = float(((inv_r - inv_rp).abs().amax(dim=(-1, -2)) /
                       inv_rp.abs().amax(dim=(-1, -2))).max())
    if not res14_err <= TOL:
        raise AssertionError(f"kernel 14 at the resume's shape: {res14_err} "
                             f"> {TOL}")
    row_extra = {"regularized_inverse": {
        "resume_514_ms": _graph_ms(torch, lambda: es.regularized_inverse(
            res14)),
        "resume_514_eager_ms": _time_ms(torch, lambda: es.regularized_inverse(
            res14)),
        "resume_514_max_rel_err": res14_err},
        "stft_planar": {"P2_S128100_ms": _graph_ms(
            torch, lambda: pl.stft_planar(wav2_d, window, True))},
        "istft_planar": {"main_path": "none: the planar path launches "
                                      "beamform_istft_planar"},
        "beamform_istft_planar": {"P2_S128100_ms": _graph_ms(
            torch, lambda: pl.beamform_istft_planar(
                *p2["planes"], p2["w"], p2["window"], p2["wss"], P2_S))}}
    # kernel 15 at WPD's shape (B = 32 x 4 s, T = 251, CGMM 10 iterations)
    # beside C1's, with the launch's layout
    wobs = cobs[:W_B, ..., :WPD_T].contiguous()
    layout = (ctypes.c_int * 3)()
    _build.check(_build.library("cacgmm_em").cacgmm_em_layout(
        N, 2, ctypes.addressof(layout)), "cacgmm_em_layout")
    bins, lanes, smem = layout

    def em_wpd():
        return ce.em(wobs, None, None, WPD_CGMM, "cg", False, init="higuchi")
    info["em"] = {"bins_a_warp": bins, "lanes_a_class": lanes,
                  "smem_bytes": smem,
                  "wpd_B32_T251_10it_ms": _graph_ms(torch, em_wpd, iters=5),
                  "wpd_B32_T251_10it_eager_ms": _time_ms(
                      torch, em_wpd, iters=5, warmup=1)}
    plain_kw = {"masked_covar": {"iters": 5, "warmup": 1},
                "regularized_inverse": {"iters": 3, "warmup": 1},
                "em": {"iters": 2, "warmup": 1}}
    kernel_kw = {"em": {"iters": 5, "warmup": 1}}
    kernels = []
    for name, replaces, run_k, run_p, (bound_ms, bound_by) in rows:
        eager_ms = _time_ms(torch, run_k, **kernel_kw.get(name, {}))
        plain_ms = _time_ms(torch, run_p, **plain_kw.get(name, {}))
        row = {
            "name": name, "route": "cuda",
            "source": source.get(name, "setk_tpu_torch/csrc/mvdr_power.cu"),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": abs_errs[name], "max_rel_err": errs[name],
            "ms": _graph_ms(torch, run_k, **{
                k: v for k, v in kernel_kw.get(name, {}).items()
                if k == "iters"}), "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library.get(name)}
        if name in info:
            label = {"regularized_inverse": "linalg_eigh_ms_info",
                     "em": "layout_and_wpd_shape",
                     "stft_covar": "rfft_frames_ms_info",
                     "stft_covar_chunks": "rfft_frames_ms_info"}.get(
                         name, "linalg_solve_ms_info")
            row[label] = info[name]
        row.update(row_extra.get(name, {}))
        kernels.append(row)
    kernels += wpe_kernels + blstm_kernels + evd_kernels
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
    # the EM steps at B=128 (20 iterations, one 512-frame bucket) and the
    # CACGMM's normalisation before its fused EM
    em_steps = {}
    gen = torch.Generator(device=dev)
    for algo, entry in (("cgmm", cgmm_em), ("cacgmm", cacgmm_em)):
        run = (lambda entry=entry: entry(cobs, 2, num_iters=CL_ITERS,
                                         frame_mask=cfm,
                                         generator=gen.manual_seed(0)))
        ms = _time_ms(torch, run, iters=5, warmup=1)
        em_steps[algo] = {"ms": ms, "audio_s_per_s": B * SECS / (ms / 1e3)}
        profiles[f"{algo}_em_B128"] = _device_profile(torch, run, ms,
                                                      iters=2)
    em_steps["cacgmm_normalize_ms"] = _time_ms(
        torch, lambda: norm_observation(cobs, axis=-2), iters=5)
    print(json.dumps({"device_profiles": profiles}))
    print(json.dumps({"clustering_steps": em_steps}))
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
        "clustering_em_steps": em_steps,
        "wpe_wpd_steps": {k: {kk: vv for kk, vv in v.items()
                              if kk != "profile"} if isinstance(v, dict)
                          else v for k, v in wpe_steps.items()},
        "blstm_steps": {k: {kk: vv for kk, vv in v.items()
                            if kk != "profile"} if isinstance(v, dict)
                        else v for k, v in blstm_steps.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
