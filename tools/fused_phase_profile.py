#!/usr/bin/env python3
"""Where kernels A (the fused STFT + masked covariance, rows 1 and 7 of
PERF.md's kernel table) and B (the fused beamform + iSTFT, rows 3 and 8)
spend their cycles, and, with --parent, how they compare with another
build of the same C entry points.

    python3 tools/fused_phase_profile.py [--parent DIR] [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/fused_mvdr.cu
with -DSETK_FUSED_PHASES (the shipped build carries no counters): every
warp of kernels A and B reads clock64() at the phase boundaries and lane 0
adds each phase's SM cycles into device counters.  On chip_smoke.py's
bench scene (16 kHz int16, a uniform mask from
numpy.random.default_rng(0)), for kernel A:

  bench_B128_N6     B = 128, 6 mics, 8 s (T = 501): the offline entry
                    (stft_covar), as every enhance_batch run at 512/256;
  chunk32_B128_N6   the same through the per-chunk entry at chunk 32
                    (stft_covar_chunks), as online MVDR;
  streaming_B1_4s   B = 1, 4 s, chunk 32: the per-chunk entry at the
                    streaming row's shape;
  bench_B128_N8     B = 128, 8 mics, 8 s: the offline entry at N = 8.

One JSON line a shape: a warp's cycles by phase (the mean over the
launched warps) and their shares,

  staging       the tables, and issuing the mask's and the next tile's
                samples' cp.async;
  transform     the warp's 512-point transform of one (frame, mic pair);
  tile_barrier  waiting at the tile's two block barriers (for the copies
                and the block's slowest warp);
  accumulation  adding the tile's frames to the thread's pair sums;
  write         writing a finished segment's sums;

and for kernel B (its weights the plain MVDR solve's on the scene, one
row an utterance, or that row for every chunk) at bench_B128_N6 (the
offline entry, beamform_istft), chunk32_B128_N6 (the per-chunk entry,
beamform_istft_online), streaming_B1_4s (the same at B = 1, 4 s) and
bench_B128_N8, a warp's cycles in

  staging        the tables, the offline weights, and issuing the next
                 tile's samples' cp.async;
  transform      the warp's forward transforms (P a frame, two frames);
  beamform       adding each transform's bins into the two frames' sums;
  inverse        the pair's inverse transform;
  ola_write      the overlap-add and the output's stores;
  tile_barrier   waiting at the tile's two block barriers;

each with the instrumented and the shipped build's ms (CUDA events), the warps
in flight an SM on average (every warp's cycles over the SMs' cycles in
the shipped call) and the output's largest error against the plain
version, relative to its peak.

--parent DIR: DIR holds another fused_mvdr.cu with the same C entry
points, e.g. a parent commit's setk_tpu_torch/csrc unpacked by `git
archive` into a gitignored directory.  Both builds are then timed in
turns (parent, this, this, parent) on the same inputs, each turn with its
build's library in the port's library table: kernel A at every shape
above, kernel B offline and online at the bench shape and at N = 8
(CUDA-graph replay and eager), covar_ema and mvdr_power (fused_mvdr.cu's
and mvdr_power.cu's other kernels on the main path), the mvdr 512/256
enhance_batch step at B = 128 with its device profile, the online step
(chunk 32) with its device profile and the streaming call (B = 1, 4 s,
chunk 32).  Every build's -Xptxas -v registers, spills and shared memory
come first.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from wpe_phase_profile import _nvcc_all, _smi  # noqa: E402

PHASES = ["staging", "transform", "tile_barrier", "accumulation", "write"]
B_PHASES = ["staging", "transform", "beamform", "inverse", "ola_write",
            "tile_barrier"]
CHUNK, ALPHA = 32, 0.8


def _scene(np, b, n, s, seed):
    """chip_smoke.py's bench scene: int16 mics around one source, and a
    uniform mask."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((b, s)).astype(np.float32) * 0.2
    wav = (np.stack([clean] * n, axis=1) +
           rng.standard_normal((b, n, s)).astype(np.float32) * 0.05)
    wav16 = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    mask = rng.random((b, s // 256 + 1, 257)).astype(np.float32)
    return wav16, mask


def _weights(torch, fm, mv, wav, mask, window):
    """The plain MVDR solve's weights on a scene: one row an utterance
    (B, 257, N), and that row for every chunk of CHUNK frames."""
    t = mask.shape[1]
    rs, rn = fm.stft_covar_plain(wav, mask, window)
    den = mask.sum(1)
    w = mv.mvdr_power_plain(
        (rs / torch.clamp(den, min=1e-6)[..., None, None]).contiguous(),
        (rn / torch.clamp(t - den, min=1e-6)[..., None, None]).contiguous())
    c = fm.num_chunks(t, CHUNK)
    return w, w[:, None].expand(-1, c, -1, -1).contiguous()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a directory with another fused_mvdr.cu to "
                             "time beside this one")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_phase_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.dsp.window import wss_inverse_blocks
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import fused_mvdr as fm
    from setk_tpu_torch.ops.cuda import mvdr as mv
    from setk_tpu_torch.parallel.enhance_step import enhance_batch

    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    shipped_log = _b._finish("fused_mvdr", _b._start("fused_mvdr"))
    this = {"fused_mvdr": _b.library("fused_mvdr")}
    phases = _nvcc_all(_b, {"fused_mvdr": _b.SOURCE_DIR / "fused_mvdr.cu"},
                       "phases", ["-DSETK_FUSED_PHASES"])
    builds = {"this": shipped_log}
    libs = {"this": this}
    if args.parent:
        parent = _nvcc_all(_b, {"fused_mvdr": Path(args.parent) /
                                "fused_mvdr.cu"}, "parent")
        libs["parent"] = {"fused_mvdr": parent["fused_mvdr"][0]}
        builds["parent"] = parent["fused_mvdr"][1]
    emit({"ptxas": {label: cs._ptxas_summary(log)
                    for label, log in builds.items()}, "card": card})
    lib_phases = phases["fused_mvdr"][0]
    for fn in ("fused_phase_read", "fused_b_phase_read"):
        getattr(lib_phases, fn).argtypes = [ctypes.c_void_p]
        getattr(lib_phases, fn).restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    cfg = StftConfig()
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)

    def use(table):
        _b._loaded.update(table)

    def put(wav16, mask):
        return (torch.from_numpy(wav16).to(dev),
                torch.from_numpy(mask).to(dev))

    wav_d, mask_d = put(*_scene(np, cs.B, cs.N, cs.S, 0))
    st_s = 4 * cs.SR
    st_wav = wav_d[:1, :, :st_s].contiguous()
    st_mask = mask_d[:1, :st_s // 256 + 1].contiguous()
    wav8_d, mask8_d = put(*_scene(np, cs.B, 8, cs.S, 1))
    shapes = {"bench_B128_N6": (wav_d, mask_d, None),
              "chunk32_B128_N6": (wav_d, mask_d, CHUNK),
              "streaming_B1_4s": (st_wav, st_mask, CHUNK),
              "bench_B128_N8": (wav8_d, mask8_d, None)}

    def kernel_a(wav, mask, chunk):
        if chunk is None:
            return lambda: fm.stft_covar(wav, mask, window)
        return lambda: fm.stft_covar_chunks(wav, mask, window, chunk)

    def plain_a(wav, mask, chunk):
        if chunk is None:
            return torch.cat(fm.stft_covar_plain(wav, mask, window), -1)
        return fm.stft_covar_chunks_plain(wav, mask, window, chunk)

    def warps(wav, chunk):
        """Kernel A's launched warps, as the wrappers and the launcher
        size the grid."""
        b, n, s = wav.shape
        t = s // 256 + 1
        lay = fm.kernel_a_layout(n, True, dev)
        slots = lay["blocks_per_sm"] * lay["sms"]
        if chunk is None:
            blocks = fm.frame_runs(b, t, slots, lay["frames_a_tile"])
        else:
            c = fm.num_chunks(t, chunk)
            spb = max(1, min(max(1, 32 // chunk), -(-b * c // slots)))
            blocks = -(-c // spb)
        return b * blocks * lay["threads"] // 32, lay["sms"]

    for label, (wav, mask, chunk) in shapes.items():
        fn = kernel_a(wav, mask, chunk)
        ref = plain_a(wav, mask, chunk)
        cycles = (ctypes.c_ulonglong * 5)()
        use({"fused_mvdr": lib_phases})
        _b.check(lib_phases.fused_phase_read(ctypes.addressof(cycles)),
                 "fused_phase_read")  # zero them
        got_i = fn()
        torch.cuda.synchronize()
        _b.check(lib_phases.fused_phase_read(ctypes.addressof(cycles)),
                 "fused_phase_read")
        instrumented_ms = cs._time_ms(torch, fn, iters=5, warmup=1)
        use(this)
        got = fn()
        kernel_ms = cs._time_ms(torch, fn, iters=10, warmup=1)
        clock = _smi("clocks.sm")
        launched, sms = warps(wav, chunk)
        per_warp = [cycles[i] / launched for i in range(len(PHASES))]
        total = sum(per_warp)

        def flat(x):
            return torch.cat(x, -1) if isinstance(x, tuple) else x
        emit({"shape": label, "B": wav.shape[0], "N": wav.shape[1],
              "T": mask.shape[1], "chunk": chunk, "warps": launched,
              "warp_cycles": dict(zip(PHASES, per_warp)),
              "share": {p: c / total for p, c in zip(PHASES, per_warp)},
              "instrumented_ms": instrumented_ms, "kernel_ms": kernel_ms,
              "warps_in_flight_per_sm": total * launched / (
                  sms * kernel_ms * 1e-3 * float(clock.split()[0]) * 1e6),
              "instrumented_max_rel_err": cs._rel(flat(got_i), ref),
              "max_rel_err": cs._rel(flat(got), ref), "sm_clock": clock,
              "card": card})
        del ref

    def wss_for(s):
        return torch.as_tensor(wss_inverse_blocks(
            cfg.padded_window, s // 256 + 1, cfg.frame_hop, cfg.n_fft, s),
            device=dev)

    w, w_on = _weights(torch, fm, mv, wav_d, mask_d, window)
    w8, _ = _weights(torch, fm, mv, wav8_d, mask8_d, window)
    w_st = w_on[:1, :fm.num_chunks(st_s // 256 + 1, CHUNK)].contiguous()
    wss_inv, wss_st = wss_for(cs.S), wss_for(st_s)
    b_shapes = {
        "bench_B128_N6": (lambda: fm.beamform_istft(wav_d, w, wss_inv,
                                                    window),
                          lambda: fm.beamform_istft_plain(wav_d, w, wss_inv,
                                                          window), None),
        "chunk32_B128_N6": (
            lambda: fm.beamform_istft_online(wav_d, w_on, wss_inv, window,
                                             CHUNK),
            lambda: fm.beamform_istft_online_plain(wav_d, w_on, wss_inv,
                                                   window, CHUNK), CHUNK),
        "streaming_B1_4s": (
            lambda: fm.beamform_istft_online(st_wav, w_st, wss_st, window,
                                             CHUNK),
            lambda: fm.beamform_istft_online_plain(st_wav, w_st, wss_st,
                                                   window, CHUNK), CHUNK),
        "bench_B128_N8": (lambda: fm.beamform_istft(wav8_d, w8, wss_inv,
                                                    window),
                          lambda: fm.beamform_istft_plain(wav8_d, w8,
                                                          wss_inv, window),
                          None)}
    b_wav = {"bench_B128_N6": wav_d, "chunk32_B128_N6": wav_d,
             "streaming_B1_4s": st_wav, "bench_B128_N8": wav8_d}
    for label, (fn, plain, chunk) in b_shapes.items():
        wav = b_wav[label]
        ref = plain()
        cycles = (ctypes.c_ulonglong * len(B_PHASES))()
        use({"fused_mvdr": lib_phases})
        _b.check(lib_phases.fused_b_phase_read(ctypes.addressof(cycles)),
                 "fused_b_phase_read")  # zero them
        got_i = fn()
        torch.cuda.synchronize()
        _b.check(lib_phases.fused_b_phase_read(ctypes.addressof(cycles)),
                 "fused_b_phase_read")
        instrumented_ms = cs._time_ms(torch, fn, iters=5, warmup=1)
        use(this)
        got = fn()
        kernel_ms = cs._time_ms(torch, fn, iters=10, warmup=1)
        clock = _smi("clocks.sm")
        b, n, s = wav.shape
        lay = fm.kernel_b_layout(n, True, chunk is not None, b, s, dev)
        per = -(-(s // 256) // lay["runs"])   # output blocks a run
        launched = b * -(-(s // 256) // per) * lay["threads"] // 32
        per_warp = [cycles[i] / launched for i in range(len(B_PHASES))]
        total = sum(per_warp)
        emit({"kernel": "B", "shape": label, "B": b, "N": n,
              "T": s // 256 + 1, "chunk": chunk, "layout": lay,
              "warps": launched,
              "warp_cycles": dict(zip(B_PHASES, per_warp)),
              "share": {p: c / total for p, c in zip(B_PHASES, per_warp)},
              "instrumented_ms": instrumented_ms, "kernel_ms": kernel_ms,
              "warps_in_flight_per_sm": total * launched / (
                  lay["sms"] * kernel_ms * 1e-3 * float(clock.split()[0])
                  * 1e6),
              "instrumented_max_rel_err": cs._rel(got_i, ref),
              "max_rel_err": cs._rel(got, ref), "sm_clock": clock,
              "card": card})
        del ref

    if args.parent:
        t_frames = cfg.num_frames(cs.S)
        rs, rn = fm.stft_covar_plain(wav_d, mask_d, window)
        den = mask_d.sum(1)
        rs = (rs / torch.clamp(den, min=1e-6)[..., None, None]).contiguous()
        rn = (rn / torch.clamp(t_frames - den, min=1e-6)[..., None, None]
              ).contiguous()
        part = fm.stft_covar_chunks_plain(wav_d, mask_d, window, CHUNK)
        kernels = {f"stft_covar@{label}": kernel_a(*x)
                   for label, x in shapes.items()}
        kernels.update({f"beamform_istft@{label}": b_shapes[label][0]
                        for label in ("bench_B128_N6", "bench_B128_N8")})
        kernels["beamform_istft_online@chunk32_B128_N6"] = b_shapes[
            "chunk32_B128_N6"][0]
        kernels["covar_ema@chunk32_B128_N6"] = (
            lambda: fm.covar_ema(part, mask_d, CHUNK, ALPHA))
        kernels["mvdr_power@bench_B128_N6"] = lambda: mv.mvdr_power(rs, rn)

        def mvdr_step():
            return enhance_batch(wav_d, mask_d, cfg, beamformer="mvdr")

        steps = {
            "mvdr_512_256_B128": mvdr_step,
            "online_chunk32_B128": lambda: enhance_batch(
                wav_d, mask_d, cfg, chunk_size=CHUNK, alpha=ALPHA),
            "streaming_B1_4s_chunk32": lambda: enhance_batch(
                st_wav, st_mask, cfg, chunk_size=CHUNK, alpha=ALPHA)}
        for turn, build in enumerate(("parent", "this", "this", "parent")):
            use(libs[build])
            row = {"turn": turn, "build": build, "kernels": {}, "steps": {},
                   "card": card}
            for label, fn in kernels.items():
                # 50 launches: mvdr_power's 12 us spread by ~5 % at 10
                row["kernels"][label] = {
                    "ms": cs._graph_ms(torch, fn, iters=50),
                    "eager_ms": cs._time_ms(torch, fn, iters=50)}
            for label, fn in steps.items():
                ms = cs._time_ms(torch, fn, iters=10, warmup=2)
                row["steps"][label] = {"ms": ms}
                if label != "streaming_B1_4s_chunk32":
                    row["steps"][label]["profile"] = cs._device_profile(
                        torch, fn, ms, iters=3)
            row["steps"]["streaming_B1_4s_chunk32"]["ms_per_chunk"] = (
                row["steps"]["streaming_B1_4s_chunk32"]["ms"] /
                fm.num_chunks(st_s // 256 + 1, CHUNK))
            emit(row)
        use(this)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
