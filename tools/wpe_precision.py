#!/usr/bin/env python3
"""How far WPE's float32 loop lies from a float64 run, and where from.

    python3 tools/wpe_precision.py [--batch 32] [--out FILE]

Needs one CUDA card.  On chip_smoke.py's WPE scenes (6 mics, 8 s at
16 kHz, STFT 512/256, taps 10, delay 3, context 1, 3 iterations) it runs
the fused WPE loop (Gram -> solve per iteration, application at the end)
in several arithmetics and prints one JSON line per scene and variant
with its distance from the float64 loop through the plain versions:

  kernels        kernels 18, 17 and 19 on the card
  plain_card     their plain versions on the card (cuBLAS Grams)
  plain_cpu      their plain versions on the CPU
  kgram_psolve   kernel 18's Grams, the plain solve, the plain application
  pgram_ksolve   the plain Grams, kernel 17's solve, the plain application
  gram64         Grams formed in float64 from the float32 state and
                 rounded to complex64, the float32 plain solve
  solve64        float32 plain Grams, solves in float64
  gram_tiled     float32 Grams summed per 64-frame tile, then over the
                 tiles (a two-level sum), the float32 plain solve
  f64_ulp_<s>    the float64 loop on the input perturbed by one float32
                 unit in the last place (seed s): the problem's own
                 sensitivity, which no float32 loop can be asked to beat

Scenes: "noise" (bench_secondary.py:123-127), "reverberant" (a source
through ten echoes, noise at 0.02) and "noise_padded" (the noise scene
zero-padded to BatchWpe's 131072-sample bucket, as chip_smoke's W3 runs
it).  Distances, on the (B, F, N, T) spectra: the largest |diff| over the
float64 output's peak, the same per utterance (median, 90th percentile,
largest), the relative Frobenius norm, and the share of bins whose
largest |diff| exceeds 2e-3 of the peak.  For the float64 run's loaded
tap correlation at the last iteration it prints the condition number's
quantiles over bins and at the five bins where the kernels err most.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SCENES = ("noise", "reverberant", "noise_padded")
BUCKET = 131072        # BatchWpe's bucket for an 8 s utterance


def _loop(flat, gram_fn, solve_fn, apply_fn, iters):
    """-> (output, the last filter, the last iteration's Gram)."""
    g = None
    for i in range(iters):
        gram = gram_fn(flat, g, i > 0)
        g = solve_fn(gram)
    return apply_fn(flat, g), g, gram


def _variants(torch, ch, wg, n, taps, delay, ctx):
    nk = n * taps
    c64, c128 = torch.complex64, torch.complex128

    def k_gram(f, g, use_g):
        return wg.wpe_gram(f, g, taps, delay, ctx, use_g)

    def p_gram(f, g, use_g):
        return wg.wpe_gram_plain(f, g, taps, delay, ctx, use_g)

    def gram64(f, g, use_g):
        g64 = None if g is None else g.to(c128)
        return wg.wpe_gram_plain(f.to(c128), g64, taps, delay, ctx,
                                 use_g).to(c64)

    def gram_tiled(f, g, use_g):
        rows = wg.tap_rows(f, taps, delay)
        d = f - g.conj().transpose(-1, -2) @ rows if use_g else f
        sw = torch.rsqrt(torch.clamp(wg._smoothed_power(d, ctx),
                                     min=wg.EPSILON))
        a = torch.cat([f, rows], dim=-2) * sw[..., None, :]
        gram = sum(a[..., i:i + 64] @ a[..., i:i + 64].conj().transpose(
            -1, -2) for i in range(0, a.shape[-1], 64))
        upper = torch.triu(gram, diagonal=1)
        return upper + upper.conj().transpose(-1, -2) + torch.diag_embed(
            torch.diagonal(gram, dim1=-2, dim2=-1).real).to(gram.dtype)

    def k_solve(gram):
        return ch.solve_wpe_gram(gram, n, nk, n)

    def p_solve(gram):
        return ch.solve_wpe_gram_plain(gram, n, nk, n)

    def solve64(gram):
        return ch.solve_wpe_gram_plain(gram.to(c128), n, nk, n).to(c64)

    def k_apply(f, g):
        return wg.wpe_apply(f, g, taps, delay)

    def p_apply(f, g):
        return wg.wpe_apply_plain(f, g, taps, delay)

    return {"kernels": (k_gram, k_solve, k_apply, "cuda"),
            "plain_card": (p_gram, p_solve, p_apply, "cuda"),
            "plain_cpu": (p_gram, p_solve, p_apply, "cpu"),
            "kgram_psolve": (k_gram, p_solve, p_apply, "cuda"),
            "pgram_ksolve": (p_gram, k_solve, p_apply, "cuda"),
            "gram64": (gram64, p_solve, p_apply, "cuda"),
            "solve64": (p_gram, solve64, p_apply, "cuda"),
            "gram_tiled": (gram_tiled, p_solve, p_apply, "cuda")}


def _distance(np, got, ref):
    d = (got - ref).abs()
    peak = float(ref.abs().max())
    per_utt = (d.flatten(1).max(1).values /
               ref.abs().flatten(1).max(1).values).cpu().numpy()
    per_bin = d.amax(dim=(-2, -1)) / peak
    return {"max_rel": float(d.max()) / peak,
            "per_utt_median": float(np.median(per_utt)),
            "per_utt_p90": float(np.quantile(per_utt, 0.9)),
            "per_utt_max": float(per_utt.max()),
            "rel_fro": float(d.norm() / ref.abs().norm()),
            "bins_over_2e-3": float((per_bin > 2e-3).float().mean()),
            "finite": bool(got.isfinite().all())}, per_bin


def _conditions(torch, gram64, n, eps_rel=1e-6):
    """Condition numbers of the loaded tap correlation, (bins,) float64,
    with kernel 17's loading (eps_rel / NK) tr + EPSILON."""
    from setk_tpu_torch.utils.common import EPSILON
    corr = gram64[:, n:, n:].cpu()
    tr = torch.diagonal(corr, dim1=-2, dim2=-1).real.sum(-1)
    ev = torch.linalg.eigvalsh(corr) + ((eps_rel / corr.shape[-1]) * tr +
                                        EPSILON)[:, None]
    return (ev[:, -1] / ev[:, 0].clamp(min=1e-300)).numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=cs.W_B)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script (every variant plain)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "wpe_precision.jsonl"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("wpe_precision: no CUDA device", file=sys.stderr)
        return 2
    from setk_tpu_torch.dsp.stft import StftConfig
    from setk_tpu_torch.ops.cuda import cholesky as ch
    from setk_tpu_torch.ops.cuda import wpe_gram as wg
    from setk_tpu_torch.utils.device import full_f32_matmuls
    dev = torch.device(args.device)
    full_f32_matmuls(dev)
    cfg = StftConfig()
    n, taps, delay, ctx, iters = (cs.N, cs.W_TAPS, cs.W_DELAY, cs.W_CONTEXT,
                                  cs.W_ITERS)
    s = cs.W_SECS * cs.SR
    variants = _variants(torch, ch, wg, n, taps, delay, ctx)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(json.dumps(rec))

    card = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__, "batch": args.batch})
    for scene in SCENES:
        wav = cs._wpe_scene(args.batch, n, s, 21 if scene == "reverberant"
                            else 20, scene == "reverberant")
        if scene == "noise_padded":
            wav = np.pad(wav, ((0, 0), (0, 0), (0, BUCKET - s)))
        obs = cs._spectra(torch, torch.from_numpy(wav).to(dev), cfg)
        b, f, _, t = obs.shape
        flat = obs.reshape(-1, n, t)
        ref, g_ref, gram_last = _loop(flat.to(torch.complex128),
                                      *variants["plain_card"][:3], iters)
        ref = ref.reshape(b, f, n, t)
        kappa = _conditions(torch, gram_last, n)
        del gram_last
        worst = None
        for name, (gram_fn, solve_fn, apply_fn, where) in variants.items():
            x = flat.cpu() if where == "cpu" else flat
            got, g, _ = _loop(x, gram_fn, solve_fn, apply_fn, iters)
            got = got.reshape(b, f, n, t).to(dev).to(torch.complex128)
            dist, per_bin = _distance(np, got, ref)
            g_err = ((g.to(dev).to(torch.complex128) - g_ref).flatten(1)
                     .norm(dim=1) / g_ref.flatten(1).norm(dim=1)
                     .clamp(min=1e-300)).cpu().numpy()
            dist["filter_rel_p50_p99_max"] = [
                float(np.median(g_err)), float(np.quantile(g_err, 0.99)),
                float(g_err.max())]
            if name == "kernels":
                worst = torch.topk(per_bin.flatten(), 5).indices.cpu()
            emit({"scene": scene, "variant": name, **dist})
            del got, g
        gen = torch.Generator(device=dev.type)
        for seed in (1, 2):
            gen.manual_seed(seed)
            rel = (torch.rand(flat.shape, generator=gen, device=dev,
                              dtype=torch.float64) * 2 - 1) * 2.0**-24
            pert = flat.to(torch.complex128) * (1 + rel)
            got, g, _ = _loop(pert, *variants["plain_card"][:3], iters)
            dist, _ = _distance(np, got.reshape(b, f, n, t), ref)
            emit({"scene": scene, "variant": f"f64_ulp_{seed}", **dist})
            del got, g, pert
        emit({"scene": scene, "kappa_quantiles_50_90_99_max": [
            float(np.quantile(kappa, q)) for q in (0.5, 0.9, 0.99, 1.0)],
            "kappa_at_kernels_worst_bins": [float(kappa[i]) for i in worst],
            "worst_bins_utt_bin": [[int(i) // f, int(i) % f] for i in worst]})
        del ref, g_ref, obs, flat
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
