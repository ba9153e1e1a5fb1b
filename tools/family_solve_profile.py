#!/usr/bin/env python3
"""Kernels 4 (gevd_power) and 5 (pmwf_solve), rows 4 and 5 of PERF.md's
kernel table, timed beside kernels 2 and 6 of the same source and, with
--parent, in turns against another build of it; and the family's fused
enhance_batch steps.

    python3 tools/family_solve_profile.py [--parent DIR] [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/
mvdr_power.cu (and fused_mvdr.cu, kernels A and B of the steps) and
prints every build's -Xptxas -v registers, spills and shared memory at
N = 1-8, then one JSON line a turn: on chip_smoke.py's gated-scene
covariances (B = 128 x 6 mics x 8 s, 32,896 bins: kernel A's Rs and Rn
of seed 1, as its step 5 forms them) kernel 2 (mvdr_power, 15
iterations), 4 at 30 and 50 iterations, 5 at beta 0 with powers and beta
1 without, and 6 (capon on mpdr-whiten's steer against Ry), each from a
CUDA-graph replay and eager, with 4's and 5's errors against their plain
versions; and, in every turn, the fused gevd, pmwf-0 and mpdr-whiten
enhance_batch steps at B = 128 x 8 s with their
device profile and idle share.

--parent DIR: DIR holds another mvdr_power.cu with the same C entry
points, e.g. a parent commit's setk_tpu_torch/csrc unpacked by `git
archive` into a gitignored directory, or a copy of this one with a
design constant changed.  Builds are timed in turns (parent, this, this,
parent), each turn with its build's library in the port's library table.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from wpe_phase_profile import _smi  # noqa: E402

STEPS = ("gevd", "pmwf-0", "mpdr-whiten")


def _nvcc_jobs(_b, jobs):
    """nvcc each {label: source} of mvdr_power into BUILD_DIR, all at
    once: -> {label: (CDLL, nvcc log)}."""
    _b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in jobs.items():
        out = _b.BUILD_DIR / f"libmvdr_power-{label}.so"
        cmd = [_b._nvcc(), *_b._FLAGS, "-o", str(out), str(src)]
        procs[label] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for label, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _b._SIGNATURES["mvdr_power"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        built[label] = (lib, log)
    return built


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a directory with another mvdr_power.cu to "
                             "time beside this one")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("family_solve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.enhance.beamformer import fix_steer_phase
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
    started = {name: _b._start(name) for name in ("mvdr_power", "fused_mvdr")}
    jobs = {}
    if args.parent:
        jobs["parent"] = Path(args.parent) / _b.SOURCES["mvdr_power"]
    others = _nvcc_jobs(_b, jobs)
    logs = {name: _b._finish(name, job) for name, job in started.items()}
    libs = {"this": _b.library("mvdr_power")}
    builds = {"this": logs["mvdr_power"]}
    for label, (lib, log) in others.items():
        libs[label] = lib
        builds[label] = log
    emit({"ptxas": {label: cs._ptxas_summary(log) or "built before"
                    for label, log in builds.items()}, "card": card})
    (_b.BUILD_DIR / "ptxas_family_solve.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in builds.items()))

    dev = torch.device("cuda", 0)
    cfg = StftConfig()
    t_frames = cfg.num_frames(cs.S)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    gwav16, gmask, _ = cs._gated_scene(cs.B, cs.N, cs.S, seed=1)
    gwav_d = torch.from_numpy(gwav16).to(dev)
    gmask_d = torch.from_numpy(gmask).to(dev)
    rs_num, rn_num = fm.stft_covar(gwav_d, gmask_d, window)
    gden = gmask_d.sum(1)
    grs = (rs_num / torch.clamp(gden, min=1e-6)[..., None, None]
           ).contiguous()
    grn = (rn_num / torch.clamp(t_frames - gden, min=1e-6)[..., None, None]
           ).contiguous()
    gry = ((rs_num + rn_num) / t_frames).contiguous()
    gsteer = fix_steer_phase((grn * mv.gevd_power_plain(
        grs, grn, power_iters=50)[..., None, :]).sum(-1)).contiguous()
    bins = cs.B * cfg.num_bins
    vec_bytes = bins * cs.N * 8
    bounds = {
        "gevd_power@30": cs._bound(grs.nbytes + grn.nbytes + vec_bytes,
                                   cs._flops_gevd(bins, cs.N, 30)),
        "gevd_power@50": cs._bound(grs.nbytes + grn.nbytes + vec_bytes,
                                   cs._flops_gevd(bins, cs.N, 50)),
        "pmwf_solve@beta0_powers": cs._bound(
            2 * grs.nbytes + grn.nbytes + 2 * bins * cs.N * 4,
            cs._flops_pmwf(bins, cs.N))}
    emit({"bins": bins, "bound_ms": bounds, "card": card})
    ref = {"gevd_power@30": mv.gevd_power_plain(grs, grn, 30),
           "gevd_power@50": mv.gevd_power_plain(grs, grn, 50),
           "pmwf_solve@beta0_powers": mv.pmwf_solve_plain(
               grs, grn, 0.0, return_powers=True),
           "pmwf_solve@beta1": (mv.pmwf_solve_plain(grs, grn, 1.0),)}
    kernels = {
        "mvdr_power": lambda: mv.mvdr_power(grs, grn),
        "gevd_power@30": lambda: mv.gevd_power(grs, grn, power_iters=30),
        "gevd_power@50": lambda: mv.gevd_power(grs, grn, power_iters=50),
        "pmwf_solve@beta0_powers": lambda: mv.pmwf_solve(
            grs, grn, 0.0, return_powers=True),
        "pmwf_solve@beta1": lambda: (mv.pmwf_solve(grs, grn, 1.0),),
        "capon": lambda: mv.capon(gsteer, gry)}
    steps = {name: (lambda name=name: enhance_batch(
        gwav_d, gmask_d, cfg, beamformer=name)) for name in STEPS}

    turns = ["this", "this"]
    if args.parent:
        turns = ["parent", *turns, "parent"]
    for turn, build in enumerate(turns):
        _b._loaded["mvdr_power"] = libs[build]
        row = {"turn": turn, "build": build, "kernels": {}, "card": card}
        for label, fn in kernels.items():
            row["kernels"][label] = {
                "ms": cs._graph_ms(torch, fn, iters=20),
                "eager_ms": cs._time_ms(torch, fn, iters=20)}
        for label, want in ref.items():
            got = kernels[label]()
            if label.startswith("gevd"):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            row["kernels"][label]["max_rel_err"] = max(
                cs._rel(g, r) for g, r in zip(got, want))
            row["kernels"][label]["max_abs_err"] = max(
                cs._abs(g, r) for g, r in zip(got, want))
        for name, fn in steps.items():
            ms = cs._time_ms(torch, fn, iters=10, warmup=2)
            row[f"{name}_step"] = {
                "ms": ms, "audio_s_per_s": cs.B * cs.SECS / ms * 1e3,
                "profile": cs._device_profile(torch, fn, ms, iters=3)}
        emit(row)
    _b._loaded["mvdr_power"] = libs["this"]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
