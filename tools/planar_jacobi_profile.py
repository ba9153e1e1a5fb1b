#!/usr/bin/env python3
"""Kernels 9 (the planar STFT) and 14 (the Jacobi regularized inverse),
rows 9 and 14 of PERF.md's kernel table, timed, and with --parent timed
in turns beside another build.

    python3 tools/planar_jacobi_profile.py [--parent DIR] [--out FILE]

Needs one CUDA card and nvcc.  It builds setk_tpu_torch/csrc/
planar_stft.cu and eigh_small.cu and prints their -Xptxas -v registers,
spills and shared memory, then one JSON line a turn: kernel 9 at P1 (B =
128 x 6 mics x 8 s int16 at n_fft 1024, hop 512, center) and P2 (512/256
at S = 128,100), kernel 10 at P1, kernel 14 at the bench shape (65,792
matrices of 6 x 6: K = 2 classes of B = 128 utterances x 257 bins,
chip_smoke.py's C1) and the CGMM CLI resume's launch (514 = 2 x 257
matrices, C3), on sample covariances of 16 random frames and on
chip_smoke.py's C1 covariances (the CGMM scan's after 4 iterations on the
gated scene), kernel 11 at P1 (another library, the turns' spread), each
from a CUDA-graph replay and eager; the errors of kernels 9 and 14
against their plain versions; and the P1 enhance_batch step with its
device profile.  Inputs are chip_smoke.py's scenes
(numpy.random.default_rng seeds).

--parent DIR: DIR holds another planar_stft.cu and eigh_small.cu (with
jacobi.cuh) with the same C entry points, e.g. a parent commit's
setk_tpu_torch/csrc unpacked by `git archive` into a gitignored directory.
Both builds are then timed in turns (parent, this, this, parent) on the
same inputs, each turn with its build's libraries in the port's library
table.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from wpe_phase_profile import _nvcc_all, _smi  # noqa: E402


def _hermitian(np, torch, dev, count, m, seed):
    """Sample covariances of 16 random frames (full rank: a rank-one
    matrix's floored spectrum is as far apart in two f32 arithmetics as
    its eigenvalues next to the floor)."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((count, m, 16)) +
         1j * rng.standard_normal((count, m, 16))).astype(np.complex64)
    a = torch.from_numpy(z).to(dev)
    return (a @ a.conj().transpose(-1, -2) / 16).contiguous()


def _em_covariances(np, torch, dev, cs):
    """chip_smoke.py's C1 matrices: the CGMM scan's K = 2 covariances
    after 4 iterations on the gated scene's STFT (B = 128 x 6 mics x 8 s,
    the 512-frame bucket): 65,792, and one utterance's 2 x 257, the CGMM
    CLI resume's launch."""
    from setk_tpu_torch.dsp.stft import StftConfig, forward_stft
    from setk_tpu_torch.enhance.cluster import cgmm_em
    from setk_tpu_torch.ops.cuda import covariance as mc
    cfg = StftConfig()
    gwav16, _, _ = cs._gated_scene(cs.B, cs.N, cs.S, seed=1)
    gwav_d = torch.from_numpy(gwav16).to(dev)
    obs = forward_stft(gwav_d.float() / 32768.0, cfg).permute(
        0, 3, 1, 2).cpu().numpy()
    bucket = -(-cfg.num_frames(cs.S) // cs.CL_BUCKET) * cs.CL_BUCKET
    cobs_np, cfm_np = cs._cluster_batch(np, list(obs), bucket)
    cobs = torch.from_numpy(cobs_np).to(dev)
    cfm = torch.from_numpy(cfm_np).to(dev)
    g4, _, st4 = cgmm_em(cobs, 2, num_iters=cs.CL_CHECK_ITERS,
                         frame_mask=cfm, return_state=True)
    w13 = (g4 * cfm * cs.N / st4["phi"]).contiguous()
    den = torch.clamp((g4 * cfm).sum(-1), min=1.1920929e-07)
    cov = (mc.masked_covar_plain(cobs, w13) / den[..., None, None])
    cov = cov.reshape(-1, cs.N, cs.N).contiguous()
    return {"em_65792": cov,
            "em_resume_514": cov.reshape(2, cs.B, 257, cs.N, cs.N)[
                :, 0].reshape(-1, cs.N, cs.N).contiguous()}


def _inv_err(torch, got, ref):
    peak = ref.abs().amax(dim=(-1, -2))
    return float(((got - ref).abs().amax(dim=(-1, -2)) / peak).max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a directory with another planar_stft.cu and "
                             "eigh_small.cu to time beside these")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("planar_jacobi_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.ops.cuda import _build as _b
    from setk_tpu_torch.ops.cuda import covariance_pair as cp
    from setk_tpu_torch.ops.cuda import eigh_small as es
    from setk_tpu_torch.ops.cuda import planar as pl
    from setk_tpu_torch.parallel.enhance_step import enhance_batch

    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    card = _smi("name,power.limit")
    print(card)
    names = ("planar_stft", "eigh_small")
    logs = {name: _b._finish(name, _b._start(name)) for name in names}
    this = {name: _b.library(name) for name in names}
    builds = {"this": "\n".join(logs.values())}
    libs = {"this": this}
    if args.parent:
        parent = _nvcc_all(_b, {name: Path(args.parent) / _b.SOURCES[name]
                                for name in names}, "parent")
        libs["parent"] = {name: lib for name, (lib, _) in parent.items()}
        builds["parent"] = "\n".join(log for _, log in parent.values())
    emit({"ptxas": {label: cs._ptxas_summary(log)
                    for label, log in builds.items()}, "card": card})
    (_b.BUILD_DIR / "ptxas_planar_jacobi.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in builds.items()))

    dev = torch.device("cuda", 0)

    def use(table):
        _b._loaded.update(table)

    # ---- kernel 14's matrices ----
    mats = {"bench_65792": _hermitian(np, torch, dev, 2 * cs.B * 257, cs.N,
                                      0),
            "resume_514": _hermitian(np, torch, dev, 2 * 257, cs.N, 1)}
    mats.update(_em_covariances(np, torch, dev, cs))
    plain = {k: es.jacobi_regularized_inverse_plain(a)
             for k, a in mats.items()}

    # ---- kernel 9 ----
    rng = np.random.default_rng(0)
    clean = rng.standard_normal((cs.B, cs.S)).astype(np.float32) * 0.2
    wav = (clean[:, None] + rng.standard_normal((cs.B, cs.N, cs.S)).astype(
        np.float32) * 0.05)
    wav_d = torch.from_numpy(np.clip(wav * 32768.0, -32768, 32767).astype(
        np.int16)).to(dev)
    del wav
    clean2 = rng.standard_normal((cs.B, cs.P2_S)).astype(np.float32) * 0.2
    wav2 = (clean2[:, None] + rng.standard_normal(
        (cs.B, cs.N, cs.P2_S)).astype(np.float32) * 0.05)
    wav2_d = torch.from_numpy(np.clip(wav2 * 32768.0, -32768, 32767).astype(
        np.int16)).to(dev)
    del wav2
    cfg1 = StftConfig(**cs.P1_FIELDS)
    cfg2 = StftConfig()
    geos = {"P1": (wav_d, cfg1), "P2": (wav2_d, cfg2)}
    win = {k: torch.as_tensor(c.padded_window, dtype=torch.float32,
                              device=dev) for k, (_, c) in geos.items()}
    ref9 = {k: pl.stft_planar_plain(w, win[k], True)
            for k, (w, _) in geos.items()}

    t1 = cfg1.num_frames(cs.S)
    mask1 = torch.from_numpy(rng.random((cs.B, t1, cfg1.num_bins)).astype(
        np.float32)).to(dev)
    planes = ref9["P1"]
    er, ei, ny = (x[:, 0].contiguous() for x in planes)
    wss = torch.as_tensor(pl.istft_wss_inverse(cfg1.padded_window, t1,
                                               cs.S), device=dev)
    msk = mask1[..., :cfg1.n_fft // 2]
    kernels = {
        "stft_planar@P1": lambda: pl.stft_planar(wav_d, win["P1"], True),
        "stft_planar@P2": lambda: pl.stft_planar(wav2_d, win["P2"],
                                                 True),
        "istft_planar@P1": lambda: pl.istft_planar(er, ei, ny, win["P1"],
                                                   wss, cs.S),
        "pair_covar_complement@P1": lambda: cp.pair_covar_complement(
            planes[0], planes[1], msk, t1),
        "regularized_inverse@bench_65792": lambda: es.regularized_inverse(
            mats["bench_65792"]),
        "regularized_inverse@resume_514": lambda: es.regularized_inverse(
            mats["resume_514"]),
        "regularized_inverse@em_65792": lambda: es.regularized_inverse(
            mats["em_65792"]),
        "regularized_inverse@em_resume_514": lambda:
            es.regularized_inverse(mats["em_resume_514"])}

    def p1_step():
        return enhance_batch(wav_d, mask1, cfg1)

    turns = ("parent", "this", "this", "parent") if args.parent else (
        "this",)
    for turn, build in enumerate(turns):
        use(libs[build])
        row = {"turn": turn, "build": build, "kernels": {}, "card": card}
        for label, fn in kernels.items():
            row["kernels"][label] = {
                "ms": cs._graph_ms(torch, fn, iters=20),
                "eager_ms": cs._time_ms(torch, fn, iters=20)}
        got9 = pl.stft_planar(wav_d, win["P1"], True)
        got14 = es.regularized_inverse(mats["resume_514"])
        torch.cuda.synchronize()
        row["stft_planar@P1_max_abs_err"] = max(
            cs._abs(g, r) for g, r in zip(got9, ref9["P1"]))
        row["regularized_inverse@resume_514_max_rel_err"] = _inv_err(
            torch, got14[0], plain["resume_514"][0])
        got14 = es.regularized_inverse(mats["em_65792"])
        row["regularized_inverse@em_65792_max_rel_err"] = _inv_err(
            torch, got14[0], plain["em_65792"][0])
        ms = cs._time_ms(torch, p1_step, iters=10, warmup=2)
        row["P1_step"] = {"ms": ms, "profile": cs._device_profile(
            torch, p1_step, ms, iters=3)}
        emit(row)
    use(this)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
