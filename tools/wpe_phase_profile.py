#!/usr/bin/env python3
"""Where the WPE kernels (18 the Gram, 17 its Gram-layout solve, 19 the
filter application, 16 the tap-matrix scan's solve) spend their cycles,
and, with --parent, how they compare with another build of the same C
entry points.

    python3 tools/wpe_phase_profile.py [--parent DIR] [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/wpe_gram.cu
and cholesky.cu with -DSETK_WPE_PHASES (the shipped builds carry no
counters): lane 0 of every warp reads clock64() at the kernels' phase
boundaries and adds each phase's SM cycles into device counters.  Two
shapes, on chip_smoke.py's noise scene (6 mics, STFT 512/256, taps 10,
delay 3):

  wpe_B32_8s  32 x 8 s (8,224 bins, T = 501), context 1: kernel 18 with
              use_g (G from the first iteration's plain solve), kernel 17
              on its Gram, kernel 19 with that G, and kernel 16 on the
              Gram's tap correlation and cross terms, as the fused wpe
              loop's later iterations and the scan call them;
  wpd_B32_4s  32 x 4 s (T = 251): kernel 18 with compute_lambda's
              lambda given, context 0, kernel 17 equilibrated (eps_rel 4
              NK EPS) and kernel 19 with its solution, as wpd's loop calls
              them.

One JSON line a shape and kernel: a warp's cycles by phase (the mean over
the launched warps) and their shares,

  kernel 18  waiting (for the tile's frames and the block's slowest
             warp), dereverb_lambda (d, lambda and sw), design_tile (the
             weighted design tile), tile_barrier (waiting for it to be
             whole, issuing the next tile's frames), products, tile_sums
             (with the Gram's write): staging is waiting + design_tile +
             tile_barrier;
  kernels 17 and 16  factor, forward, back, other (the system's load, the
             loading, the store);
  kernel 19  waiting (for the tile's window and the block, issuing the
             next window), sums, store (the current frames' reads and d's
             stores);

with the instrumented and the shipped build's ms (CUDA events), the
warps in flight an SM on average (every warp's cycles over the SMs'
cycles in the shipped call) and both outputs' largest error against the
plain version, relative to its peak.

--parent DIR: DIR holds another wpe_gram.cu and cholesky.cu (and the
headers they include) with the same C entry points, e.g. a parent
commit's setk_tpu_torch/csrc unpacked by `git archive` into a gitignored
directory.  Both builds are then timed in turns (parent, this, this,
parent) on the same inputs, each turn with its build's two libraries in
the port's library table: the kernels at both shapes (CUDA-graph replay
and eager), and the wpe (32 x 8 s, fused and the scan), wpd (32 x 4 s,
CGMM 10, 3 outer iterations) and BatchWpe (32 x 8 s from host arrays)
steps, each fused step with its device profile and idle share.  Every
build's -Xptxas -v registers, spills and shared memory come first.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

GRAM_PHASES = ["waiting", "dereverb_lambda", "design_tile", "tile_barrier",
               "products", "tile_sums"]
SOLVE_PHASES = ["factor", "forward", "back", "other"]
APPLY_PHASES = ["waiting", "sums", "store"]
EPS = 1.1920929e-07


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _gram_warps(bins, cols):
    """Kernel 18's launched warps, as gram_layout in wpe_gram.cu sizes its
    blocks."""
    nt = -(-cols // 4)
    ntiles = nt * (nt + 1) // 2
    passes = -(-ntiles // 256)
    threads = -(-(-(-ntiles // passes)) // 32) * 32
    return bins * threads // 32


def _nvcc_all(_b, sources, suffix, defines=()):
    """nvcc each of ``sources`` {name: path} into BUILD_DIR in parallel:
    -> {name: (CDLL, nvcc log)}."""
    _b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        out = _b.BUILD_DIR / f"lib{name}-{suffix}.so"
        cmd = [_b._nvcc(), *_b._FLAGS, *defines, "-o", str(out), str(src)]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _b._SIGNATURES[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        for fn in ("wpe_phase_read", "chol_phase_read", "apply_phase_read"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
                getattr(lib, fn).restype = ctypes.c_int
        built[name] = (lib, log)
    return built


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a directory with another wpe_gram.cu and "
                             "cholesky.cu to time beside these")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wpe_phase_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.enhance import wpe as tw
    from setk_tpu_torch.enhance.wpe import compute_lambda
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import cholesky as ch
    from setk_tpu_torch.ops.cuda import wpe_gram as wg
    from setk_tpu_torch.ops.cuda.lstm_seq import device_limits
    from setk_tpu_torch.parallel.executor import BatchWpe

    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    names = {"wpe_gram": "wpe_gram.cu", "cholesky": "cholesky.cu"}
    shipped_logs = {k: _b._finish(k, _b._start(k)) for k in names}
    this = {name: _b.library(name) for name in names}
    phases = _nvcc_all(_b, {k: _b.SOURCE_DIR / v
                            for k, v in names.items()},
                       "phases", ["-DSETK_WPE_PHASES"])
    builds = {"this": shipped_logs}
    libs = {"this": this}
    if args.parent:
        parent = _nvcc_all(_b, {k: Path(args.parent) / v
                                for k, v in names.items()}, "parent")
        libs["parent"] = {k: v[0] for k, v in parent.items()}
        builds["parent"] = {k: v[1] for k, v in parent.items()}
    emit({"ptxas": {label: {k: cs._ptxas_summary(log)
                            for k, log in logs.items()}
                    for label, logs in builds.items()}, "card": card})

    dev = torch.device("cuda", 0)
    sms = device_limits(dev)[0]
    cfg = StftConfig()
    n, taps, delay = cs.N, cs.W_TAPS, cs.W_DELAY
    nk, cols = n * taps, (taps + 1) * n
    torch.backends.cuda.matmul.allow_tf32 = False

    def use(table):
        _b._loaded.update(table)

    # the two shapes' inputs: (obs, G or None, lambda or None, context,
    # use_g, solve's eps_rel, equilibrate)
    shapes = {}
    wav = torch.from_numpy(cs._wpe_scene(cs.W_B, n, cs.W_SECS * cs.SR, 20,
                                         False)).to(dev)
    obs_w = cs._spectra(torch, wav, cfg)
    flat = obs_w.reshape(-1, n, obs_w.shape[-1]).contiguous()
    g_w = ch.solve_wpe_gram_plain(wg.wpe_gram_plain(
        flat, None, taps, delay, cs.W_CONTEXT, False), n, nk, n)
    shapes["wpe_B32_8s"] = (flat, g_w, None, cs.W_CONTEXT, True, 1e-6, False)
    wav = torch.from_numpy(cs._wpe_scene(cs.W_B, n, cs.WPD_SECS * cs.SR, 24,
                                         False)).to(dev)
    obs_d = cs._spectra(torch, wav, cfg)
    flat_d = obs_d.reshape(-1, n, obs_d.shape[-1]).contiguous()
    lam_d = compute_lambda(obs_d, cs.W_CONTEXT).reshape(
        flat_d.shape[0], -1).contiguous()
    shapes["wpd_B32_4s"] = (flat_d, None, lam_d, 0, False, 4.0 * nk * EPS,
                            True)

    def apply_warps(lib, bins, t):
        layout = (ctypes.c_int * 7)()
        _b.check(lib.wpe_apply_layout(bins, n, t, taps, delay, sms,
                                      ctypes.addressof(layout)),
                 "wpe_apply_layout")
        return layout[1] * layout[3] // 32

    def solve_warps(fn, bins):
        layout = (ctypes.c_int * 2)()
        _b.check(getattr(this["cholesky"], fn)(nk, n, ctypes.addressof(
            layout)), fn)
        return -(-bins // layout[0]) * layout[0], layout[0]

    # the kernels at each shape: {label: {kernel: (run, plain output)}}
    runs = {}
    for label, (obs, g, lam, ctx, use_g, e, eq) in shapes.items():
        gram_p = wg.wpe_gram_plain(obs, g, taps, delay, ctx, use_g, lam)
        x_p = ch.solve_wpe_gram_plain(gram_p, n, nk, n, e, eq)
        g_apply = g if g is not None else x_p
        runs[label] = {
            18: (lambda obs=obs, g=g, lam=lam, ctx=ctx, use_g=use_g:
                 wg.wpe_gram(obs, g, taps, delay, ctx, use_g, lam), gram_p),
            17: (lambda gram_p=gram_p, e=e, eq=eq:
                 ch.solve_wpe_gram(gram_p, n, nk, n, e, eq), x_p),
            19: (lambda obs=obs, g_apply=g_apply:
                 wg.wpe_apply(obs, g_apply, taps, delay),
                 wg.wpe_apply_plain(obs, g_apply, taps, delay))}
        if use_g:
            corr = gram_p[:, n:, n:].contiguous()
            cross = gram_p[:, n:, :n].contiguous()
            runs[label][16] = (
                lambda corr=corr, cross=cross:
                ch.hermitian_solve_lanes(corr, cross),
                ch.hermitian_solve_lanes_plain(corr, cross))

    for label, (obs, *_) in shapes.items():
        bins, t = obs.shape[0], obs.shape[-1]
        for kernel, (fn, ref) in runs[label].items():
            lib_name, read, names_ = {
                18: ("wpe_gram", "wpe_phase_read", GRAM_PHASES),
                17: ("cholesky", "chol_phase_read", SOLVE_PHASES),
                16: ("cholesky", "chol_phase_read", SOLVE_PHASES),
                19: ("wpe_gram", "apply_phase_read", APPLY_PHASES)}[kernel]
            per_block = None
            if kernel == 18:
                warps = _gram_warps(bins, cols)
            elif kernel == 19:
                warps = apply_warps(this["wpe_gram"], bins, t)
            else:
                warps, per_block = solve_warps(
                    "gram_solve_layout" if kernel == 17 else
                    "hermitian_solve_layout", bins)
            lib = phases[lib_name][0]
            read_fn = getattr(lib, read)
            cycles = (ctypes.c_ulonglong * 8)()
            use({lib_name: lib})
            _b.check(read_fn(ctypes.addressof(cycles)), read)  # zero them
            got_i = fn()
            torch.cuda.synchronize()
            _b.check(read_fn(ctypes.addressof(cycles)), read)
            instrumented_ms = cs._time_ms(torch, fn, iters=5, warmup=1)
            use(this)
            got = fn()
            kernel_ms = cs._time_ms(torch, fn, iters=5, warmup=1)
            clock = _smi("clocks.sm")
            per_warp = [cycles[i] / warps for i in range(len(names_))]
            total = sum(per_warp)
            emit({"kernel": kernel, "shape": label, "bins": bins, "T": t,
                  "warps": warps, "systems_a_block": per_block,
                  "warp_cycles": dict(zip(names_, per_warp)),
                  "share": {p: c / total for p, c in zip(names_, per_warp)},
                  "instrumented_ms": instrumented_ms, "kernel_ms": kernel_ms,
                  "warps_in_flight_per_sm": total * warps / (
                      sms * kernel_ms * 1e-3 * float(clock.split()[0]) *
                      1e6),
                  "instrumented_max_rel_err": cs._rel(got_i, ref),
                  "max_rel_err": cs._rel(got, ref), "sm_clock": clock,
                  "card": card})

    kernel_names = {18: "wpe_gram", 17: "solve_wpe_gram", 19: "wpe_apply",
                    16: "hermitian_solve_lanes"}
    if args.parent:
        utts = {f"w{i:02d}": x for i, x in enumerate(cs._wpe_scene(
            cs.W_B, n, cs.W_SECS * cs.SR, 20, False))}
        executor = BatchWpe(cfg, taps=taps, delay=delay,
                            context=cs.W_CONTEXT, num_iters=cs.W_ITERS,
                            batch_size=cs.W_B, device="cuda")

        def run_wpd():
            return tw.wpd(obs_d, cgmm_iters=cs.WPD_CGMM,
                          wpd_iters=cs.WPD_OUTER, taps=taps, delay=delay,
                          context=cs.W_CONTEXT)

        steps = {"wpe_B32_8s": (lambda: tw.wpe(obs_w), 5),
                 "wpe_scan_B32_8s": (lambda: tw.wpe(obs_w, use_fused=False),
                                     3),
                 "wpd_B32_4s": (run_wpd, 3),
                 "BatchWpe_32x8s": (lambda: cs._time_batch_wpe(
                     executor, utts), 3)}
        for turn, build in enumerate(("parent", "this", "this", "parent")):
            use(libs[build])
            row = {"turn": turn, "build": build, "kernels": {},
                   "steps": {}, "card": card}
            for label, kernels in runs.items():
                for kernel, (fn, _) in kernels.items():
                    row["kernels"][f"{kernel_names[kernel]}@{label}"] = {
                        "ms": cs._graph_ms(torch, fn, iters=10),
                        "eager_ms": cs._time_ms(torch, fn, iters=10)}
            for label, (fn, iters) in steps.items():
                ms = cs._time_ms(torch, fn, iters=iters, warmup=1)
                row["steps"][label] = {"ms": ms}
                if label != "wpe_scan_B32_8s":
                    row["steps"][label]["profile"] = cs._device_profile(
                        torch, fn, ms, iters=2)
            emit(row)
        use(this)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
