"""BSS-eval (Vincent et al. 2006) SDR/SIR/SAR without mir_eval.

The port's own copy of ``setk_tpu/metrics/bss.py`` (host numpy and
scipy, float64): each estimate is decomposed by least-squares projection
onto ``flen``-tap shifted versions of the references (s_target from the
matching reference alone, e_interf from the span of all references,
e_artif the remainder), the source permutation chosen by SIR.
"""

from itertools import permutations

import numpy as np
from scipy.linalg import solve_toeplitz, toeplitz

__all__ = ["bss_eval_sdr", "bss_eval_sources"]

_FLEN = 512


def _fft_corr(a, b, flen):
    """Cross-correlation r[k] = sum_t a[t - k] * b[t] for k in [0, flen)."""
    n = 1 << int(np.ceil(np.log2(len(a) + flen - 1)))
    fa = np.fft.rfft(a, n)
    fb = np.fft.rfft(b, n)
    r = np.fft.irfft(np.conj(fa) * fb, n)
    return r[:flen]


def _project_single(est, ref, flen=_FLEN):
    """Least-squares projection of est onto flen shifted copies of ref,
    the full length-(n + flen - 1) projection (mir_eval's convention)."""
    # autocorrelation (Toeplitz) and cross-correlation right-hand side
    acorr = _fft_corr(ref, ref, flen)
    rhs = _fft_corr(ref, est, flen)
    acorr = acorr.copy()
    acorr[0] += 1e-10 * (acorr[0] + 1.0)
    taps = solve_toeplitz((acorr, acorr), rhs)
    return np.convolve(ref, taps)


def _project_span(est, refs, flen=_FLEN):
    """Projection of est onto the span of shifted copies of ALL refs."""
    nsrc = refs.shape[0]
    gram = np.zeros((nsrc * flen, nsrc * flen))
    rhs = np.zeros(nsrc * flen)
    for i in range(nsrc):
        rhs[i * flen:(i + 1) * flen] = _fft_corr(refs[i], est, flen)
        for j in range(i, nsrc):
            # block Toeplitz from the cross-correlation sequence
            rij = _fft_corr(refs[i], refs[j], flen)
            rji = _fft_corr(refs[j], refs[i], flen)
            block = toeplitz(rij, rji)
            gram[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = block
            if i != j:
                gram[j * flen:(j + 1) * flen,
                     i * flen:(i + 1) * flen] = block.T
    gram += np.eye(nsrc * flen) * 1e-10 * (np.trace(gram) / (nsrc * flen) + 1)
    coef = np.linalg.solve(gram, rhs)
    proj = np.zeros(len(est) + flen - 1)
    for j in range(nsrc):
        proj += np.convolve(refs[j], coef[j * flen:(j + 1) * flen])
    return proj


def _db(num, den, eps=1e-12):
    return 10 * np.log10((num + eps) / (den + eps))


def bss_eval_sources(est, ref, flen=_FLEN, compute_permutation=True):
    """(sdr, sir, sar, perm) for ``est``/``ref`` of shape (nsrc, nsamps)."""
    est = np.atleast_2d(np.asarray(est, dtype=np.float64))
    ref = np.atleast_2d(np.asarray(ref, dtype=np.float64))
    nsrc = est.shape[0]
    n = min(est.shape[1], ref.shape[1])
    est, ref = est[:, :n], ref[:, :n]

    sdr = np.zeros((nsrc, nsrc))
    sir = np.zeros((nsrc, nsrc))
    sar = np.zeros((nsrc, nsrc))
    for i in range(nsrc):  # estimate index
        # mir_eval convention: decomposition lives on the padded
        # length n + flen - 1 (projections are full convolutions)
        est_pad = np.concatenate([est[i], np.zeros(flen - 1)])
        p_all = _project_span(est[i], ref, flen) if nsrc > 1 else None
        for j in range(nsrc):  # candidate reference
            s_target = _project_single(est[i], ref[j], flen)
            if nsrc > 1:
                e_interf = p_all - s_target
                e_artif = est_pad - p_all
            else:
                e_interf = np.zeros_like(s_target)
                e_artif = est_pad - s_target
            pt = np.sum(s_target**2)
            sdr[i, j] = _db(pt, np.sum((e_interf + e_artif)**2))
            sir[i, j] = _db(pt, np.sum(e_interf**2))
            sar[i, j] = _db(np.sum((s_target + e_interf)**2),
                            np.sum(e_artif**2))
    if compute_permutation and nsrc > 1:
        perms = list(permutations(range(nsrc)))
        scores = [np.mean([sir[i, p[i]] for i in range(nsrc)]) for p in perms]
        perm = perms[int(np.argmax(scores))]
    else:
        perm = tuple(range(nsrc))
    pick = lambda m: np.array([m[i, perm[i]] for i in range(nsrc)])
    return pick(sdr), pick(sir), pick(sar), np.array(perm)


def bss_eval_sdr(est, ref, flen=_FLEN):
    """Permutation-resolved SDR per source."""
    sdr, _, _, perm = bss_eval_sources(est, ref, flen)
    return sdr, perm
