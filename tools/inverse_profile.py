#!/usr/bin/env python3
"""Kernel 14 (the Jacobi regularized inverse, csrc/eigh_small.cu, row 14
of PERF.md's kernel table) measured, and with --parent timed in turns
beside another build.

    python3 tools/inverse_profile.py [--parent DIR] [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/eigh_small.cu
as shipped and with -DSETK_EIGH_PHASES (every thread of a matrix adds the
SM cycles of each phase to device counters), and prints, one JSON line
each:

  ptxas     registers, spills and stack of kernel 14's instances (M = 1-8,
            each form built) and of the EVD's, which share the sweeps
  sweeps    the sweeps each matrix takes before the stopping test passes
            (eigh_small.inverse_sweeps_needed, cap 6; and at a cap of 20):
            chip_smoke.py's C1 covariances (the CGMM scan's K = 2
            covariances after 4 iterations on the gated scene, B = 128 x
            6 mics x 8 s: 65,792 matrices, and one utterance's 514, the
            CGMM CLI resume's launch), and the same scan's at 7 and 8 mics
            (B = 16); the operation bound recounted from them
  check     each form and the launcher's pick against the plain version
            on C1's 65,792 and 514 matrices: the largest error over each
            matrix's peak, and the five worst matrices with the sweeps
            they take and their smallest eigenvalue over the largest
  phases    a thread's cycles by phase (load, angles, updates, the lane
            form's hand-over, the ending), the sweeps its warp ran and its
            matrix took, at 514 and 65,792 matrices, each form
  cross     each form's ms (CUDA-graph replay) at M = 2-8 and 514, 4,112,
            16,448 and 65,792 matrices (C1's covariances at M = 6, sample
            covariances of 2 M + 4 random frames elsewhere): the pick's
            table kInverseLanesUpTo comes from here
  turns     kernel 14's ms from a CUDA-graph replay (and eager) at the
            resume's 514 and C1's 65,792 matrices, C1's covariances and
            random sample covariances of 16 frames, each form and the
            pick; and first in each turn the CGMM resume of one utterance
            (5 iterations from a state: 6 launches of kernel 14, 5 of
            kernel 13 and the PyTorch glue): its ms (CUDA events), the
            host's enqueue ms a call and its device profile; the EVD at 257,
            4,112 and 32,896 matrices (plain and generalized, the pick),
            whose kernels share the sweep functions

--parent DIR: DIR holds another eigh_small.cu and cacgmm_em.cu (with
jacobi.cuh), e.g. a parent commit's setk_tpu_torch/csrc unpacked by `git
archive` into a gitignored directory.  Both builds of eigh_small.cu are
timed in turns (parent, this, this, parent); a parent source without
regularized_inverse_pick (one form, no form argument) runs its one form
in every row.  Kernel 15 (cacgmm_em.cu) and the EVD are checked to give
the same bits from both builds.
"""

import argparse
import ctypes
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from planar_jacobi_profile import _em_covariances, _hermitian  # noqa: E402
from wpe_phase_profile import _nvcc_all, _smi  # noqa: E402

CROSS_COUNTS = (514, 4112, 16448, 65792)
PHASES = ["load", "angles", "updates", "handover", "ending"]
_P, _I = ctypes.c_void_p, ctypes.c_int


def _scan_covariances(np, torch, dev, m, b):
    """The CGMM scan's K = 2 covariances after 4 iterations on a gated
    scene of ``b`` utterances x ``m`` mics x 8 s (chip_smoke.py's C1 at
    other widths)."""
    from setk_tpu_torch.dsp.stft import StftConfig, forward_stft
    from setk_tpu_torch.enhance.cluster import cgmm_em
    from setk_tpu_torch.ops.cuda import covariance as mc
    cfg = StftConfig()
    gwav16, _, _ = cs._gated_scene(b, m, cs.S, seed=1)
    obs = forward_stft(torch.from_numpy(gwav16).to(dev).float() / 32768.0,
                       cfg).permute(0, 3, 1, 2).cpu().numpy()
    bucket = -(-cfg.num_frames(cs.S) // cs.CL_BUCKET) * cs.CL_BUCKET
    cobs_np, cfm_np = cs._cluster_batch(np, list(obs), bucket)
    cobs = torch.from_numpy(cobs_np).to(dev)
    cfm = torch.from_numpy(cfm_np).to(dev)
    g4, _, st4 = cgmm_em(cobs, 2, num_iters=cs.CL_CHECK_ITERS,
                         frame_mask=cfm, return_state=True)
    w13 = (g4 * cfm * m / st4["phi"]).contiguous()
    den = torch.clamp((g4 * cfm).sum(-1), min=1.1920929e-07)
    cov = mc.masked_covar_plain(cobs, w13) / den[..., None, None]
    return cov.reshape(-1, m, m).contiguous(), cobs, cfm


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a directory with another eigh_small.cu and "
                             "cacgmm_em.cu to time beside these")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("inverse_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.enhance import cluster as tc
    from setk_tpu_torch.ops import linalg
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import cacgmm_em as ce
    from setk_tpu_torch.ops.cuda import eigh_small as es

    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    names = ("eigh_small", "cacgmm_em")
    jobs = {("this", name): _b.SOURCE_DIR / _b.SOURCES[name]
            for name in names}
    if args.parent:
        jobs.update({("parent", name): Path(args.parent) / _b.SOURCES[name]
                     for name in names})
    # every nvcc at once: each build's two sources, and the instrumented one
    groups = {build: ({name: path for (b, name), path in jobs.items()
                       if b == build}, ()) for build in ("this", "parent")}
    groups["phases"] = ({"eigh_small": jobs["this", "eigh_small"]},
                        ["-DSETK_EIGH_PHASES"])
    with ThreadPoolExecutor(3) as pool:
        done = {label: pool.submit(_nvcc_all, _b, srcs, label, defines)
                for label, (srcs, defines) in groups.items() if srcs}
        done = {label: fut.result() for label, fut in done.items()}
    built = {(build, name): v for build in ("this", "parent")
             for name, v in done.get(build, {}).items()}
    phased = done["phases"]["eigh_small"][0]
    phased.eigh_phase_read.argtypes = [_P]
    phased.eigh_phase_read.restype = _I
    libs = {build: built[build, "eigh_small"][0]
            for build in ("this", "parent") if (build, "eigh_small") in built}
    # a parent before the form argument: regularized_inverse_launch(a,
    # inv, logdet, n, m, sweeps, stream)
    old_entry = {b: not hasattr(lib, "regularized_inverse_pick")
                 for b, lib in libs.items()}
    for b, lib in libs.items():
        if old_entry[b]:
            lib.regularized_inverse_launch.argtypes = [_P] * 3 + [_I] * 3 + [
                _P]
    emit({"ptxas": {b: {k: v for k, v in cs._ptxas_summary(log).items()
                        if k.startswith(("regularized_inverse",
                                         "hermitian_eigh"))}
                    for (b, name), (_, log) in built.items()
                    if name == "eigh_small"}, "card": card})

    dev = torch.device("cuda", 0)

    def launch(lib, a, form=None, old=False):
        m = a.shape[-1]
        n = a.numel() // (m * m)
        inv = torch.empty_like(a)
        ld = torch.empty(a.shape[:-2], device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (a.data_ptr(), inv.data_ptr(), ld.data_ptr(), n, m, es.SWEEPS)
        if old:
            err = lib.regularized_inverse_launch(*ptrs, stream)
        else:
            err = lib.regularized_inverse_launch(
                *ptrs, {None: -1, "thread": 0, "lanes": 1}[form], stream)
        _b.check(err, "regularized_inverse_launch")
        return inv, ld

    # ---- matrices ----
    em = _em_covariances(np, torch, dev, cs)
    mats = {"em_65792": em["em_65792"], "em_resume_514": em["em_resume_514"],
            "bench_65792": _hermitian(np, torch, dev, 2 * cs.B * 257, cs.N,
                                      0),
            "resume_514": _hermitian(np, torch, dev, 2 * 257, cs.N, 1)}

    # ---- sweeps and the bound ----
    sweeps = {}
    wide = {m: _scan_covariances(np, torch, dev, m, 16)[0] for m in (7, 8)}
    for label, a in [("em_65792", mats["em_65792"]),
                     ("em_resume_514", mats["em_resume_514"])] + [
            (f"M{m}_B16", a) for m, a in wide.items()]:
        m = a.shape[-1]
        n = a.numel() // (m * m)
        taken = es.inverse_sweeps_needed(a)
        taken20 = es.inverse_sweeps_needed(a, 20)
        inv6, ld6 = es.regularized_inverse_plain(a)
        inv20, ld20 = es.regularized_inverse_plain(a, 20)
        sweeps[label] = {
            "M": m, "matrices": n, "mean": float(taken.float().mean()),
            "max": int(taken.max()),
            "histogram": torch.bincount(taken.reshape(-1),
                                        minlength=es.SWEEPS + 1).tolist(),
            "cap20_max": int(taken20.max()),
            "cap6_vs_cap20_max_abs": max(cs._abs(inv6, inv20),
                                         cs._abs(ld6, ld20)),
            "bound": cs._bound(2 * a.nbytes + n * 4, cs._flops_inverse(
                m, float(taken.sum()), n)),
            "bound_at_cap": cs._bound(2 * a.nbytes + n * 4,
                                      n * cs._flops_jacobi(m, es.SWEEPS))}
    emit({"sweeps": sweeps, "card": card})

    # ---- each form against the plain version ----
    _b._loaded["eigh_small"] = libs["this"]
    forms = (None,) + es.inverse_forms(cs.N)
    check = {}
    for label in ("em_65792", "em_resume_514", "resume_514"):
        errs, _, worst = cs._inverse_check(torch, es, mats[label], forms)
        check[label] = {"max_rel_err": {k: e for k, (e, _) in errs.items()},
                        "max_abs_err": {k: a for k, (_, a) in errs.items()},
                        "form": es.inverse_form(
                            mats[label].numel() // cs.N ** 2, cs.N),
                        "worst": worst}
    emit({"check": check, "tol": cs.TOL, "card": card})

    # ---- the same bits from both builds: kernel 15 and the EVD ----
    if "parent" in libs:
        same = {}
        _, cobs, cfm = _scan_covariances(np, torch, dev, cs.N, 8)
        outs = {}
        for build in ("this", "parent"):
            _b._loaded["cacgmm_em"] = built[build, "cacgmm_em"][0]
            _b._loaded["eigh_small"] = libs[build]
            g, q = ce.em(cobs, None, None, 6, "cg", False, frame_mask=cfm,
                         init="higuchi")
            w, v = es.hermitian_eigh(mats["bench_65792"][:4112])
            wg, vg = es.hermitian_eigh(mats["resume_514"],
                                       mats["bench_65792"][:514])
            outs[build] = (g, q, w, v, wg, vg)
        same["em"] = all(torch.equal(x, y) for x, y in zip(
            outs["this"][:2], outs["parent"][:2]))
        same["hermitian_eigh"] = all(torch.equal(x, y) for x, y in zip(
            outs["this"][2:], outs["parent"][2:]))
        emit({"same_bits": same, "card": card})
        _b._loaded["cacgmm_em"] = built["this", "cacgmm_em"][0]
        _b._loaded["eigh_small"] = libs["this"]

    # ---- a thread's cycles by phase ----
    phases = {}
    for label in ("em_resume_514", "em_65792"):
        for form in es.inverse_forms(cs.N):
            cycles = (ctypes.c_ulonglong * 8)()
            _b.check(phased.eigh_phase_read(ctypes.addressof(cycles)),
                     "eigh_phase_read")
            launch(phased, mats[label], form)
            torch.cuda.synchronize()
            _b.check(phased.eigh_phase_read(ctypes.addressof(cycles)),
                     "eigh_phase_read")
            threads = max(int(cycles[5]), 1)
            per = [c / threads for c in cycles[:5]]
            total = sum(per) or 1.0
            phases[f"{label},{form}"] = {
                "thread_cycles": dict(zip(PHASES, per)),
                "share": {p: c / total for p, c in zip(PHASES, per)},
                "threads": threads, "sweeps_run": int(cycles[6]) / threads,
                "sweeps_taken": int(cycles[7]) / threads}
    emit({"phases": phases, "sm_clock": _smi("clocks.sm"), "card": card})

    # ---- where the forms cross, at every M ----
    cross = {}
    for m in range(2, 9):
        for n in CROSS_COUNTS:
            a = (mats["em_65792"][:n].contiguous() if m == cs.N else
                 (lambda z: (z @ z.conj().transpose(-1, -2) / (2 * m + 4))
                  .contiguous())(torch.complex(*torch.randn(
                      (2, n, m, 2 * m + 4), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          n + m)))))
            for form in es.inverse_forms(m):
                cross[f"M{m},n{n},{form}"] = cs._graph_ms(
                    torch, lambda: launch(libs["this"], a, form), iters=20)
            cross[f"M{m},n{n},pick"] = es.inverse_form(n, m)
    emit({"cross": cross, "card": card})

    # ---- turns ----
    _, cobs1, cfm1 = _scan_covariances(np, torch, dev, cs.N, 1)
    _, _, state = tc.cgmm_em(cobs1, 2, num_iters=4, frame_mask=cfm1,
                             return_state=True)
    jacobi_now = linalg.jacobi_inverse

    def resume():
        return tc.cgmm_em(cobs1, 2, num_iters=cs.CL_RESUME_ITERS,
                          frame_mask=cfm1, state=state)

    turns = ("parent", "this", "this", "parent") if "parent" in libs else (
        "this",)
    evd = {n: cs._eigh_inputs(torch, dev, n, cs.N, seed=7)
           for n in (257, 4112, 32896)}

    def eigh(lib, a, b):
        w = torch.empty(a.shape[:-1], device=dev)
        v = torch.empty_like(a)
        _b.check(lib.hermitian_eigh_form_launch(
            a.data_ptr(), None if b is None else b.data_ptr(), w.data_ptr(),
            v.data_ptr(), a.shape[0], cs.N, es.EIGH_SWEEPS, 1e-6, -1,
            torch.cuda.current_stream().cuda_stream), "hermitian_eigh")
        return w, v
    for turn, build in enumerate(turns):
        lib, old = libs[build], old_entry[build]
        row = {"turn": turn, "build": build, "card": card, "kernels": {}}
        # the resume first in the turn: ms (CUDA events), the host's
        # enqueue ms a call (no synchronize inside the 10) and the device
        # profile
        linalg.jacobi_inverse = lambda covar, lib=lib, old=old: launch(
            lib, covar.contiguous(), None, old)
        ms = cs._time_ms(torch, resume, iters=20, warmup=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            resume()
        enqueue = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        row["cgmm_resume"] = {"ms": ms, "enqueue_ms": enqueue,
                              "profile": cs._device_profile(torch, resume,
                                                            ms, iters=3)}
        linalg.jacobi_inverse = jacobi_now
        for label, a in mats.items():
            for form in (forms if not old else (None,)):
                key = f"{label},{form or 'pick'}"
                row["kernels"][key] = {
                    "ms": cs._graph_ms(torch, lambda: launch(
                        lib, a, form, old), iters=20),
                    "eager_ms": cs._time_ms(torch, lambda: launch(
                        lib, a, form, old), iters=20)}
        # the EVD, whose kernels share the sweep functions, at the
        # launcher's pick
        for n, (a, b) in evd.items():
            for gen in (False, True):
                row["kernels"][f"eigh_n{n},{'gen' if gen else 'eigh'}"] = {
                    "ms": cs._graph_ms(torch, lambda: eigh(
                        lib, a, b if gen else None), iters=20)}
        got = launch(lib, mats["em_resume_514"], None, old)[0]
        ref = es.regularized_inverse_plain(mats["em_resume_514"])[0]
        row["em_resume_514_max_rel_err_vs_new_plain"] = float((
            (got - ref).abs().amax(dim=(-1, -2)) /
            ref.abs().amax(dim=(-1, -2))).max())
        emit(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
