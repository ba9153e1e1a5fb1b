"""Scale-invariant SNR (Si-SNR/Si-SDR), batched, with a permutation search.

The port's counterpart of ``setk_tpu/metrics/sisnr.py`` (zero-mean
projection, 20 log10 ratio, the best mean over source permutations), on
tensors: the computation runs on the inputs' device (numpy inputs on the
CPU).
"""

from itertools import permutations

import numpy as np
import torch

__all__ = ["si_snr", "batch_si_snr", "permute_si_snr"]


def si_snr(x, s, eps: float = 1e-8, remove_dc: bool = True):
    """Si-SNR of estimate ``x`` vs reference ``s`` over the last axis.

    Accepts arbitrary leading batch axes; returns dB with the same
    leading shape.
    """
    x = torch.as_tensor(x)
    s = torch.as_tensor(s, device=x.device)
    if remove_dc:
        x = x - torch.mean(x, dim=-1, keepdim=True)
        s = s - torch.mean(s, dim=-1, keepdim=True)
    t = (torch.sum(x * s, dim=-1, keepdim=True) * s /
         (torch.sum(s * s, dim=-1, keepdim=True) + eps))
    n = x - t
    ratio = (torch.linalg.vector_norm(t, dim=-1) /
             (torch.linalg.vector_norm(n, dim=-1) + eps))
    return 20 * torch.log10(ratio + eps)


# alias used in batch pipelines
batch_si_snr = si_snr


def permute_si_snr(xlist, slist, align: bool = False):
    """Max average Si-SNR over source permutations.

    ``xlist``/``slist``: sequences (or stacked tensors with a leading
    source axis) of equal-length signals.  With ``align=True`` also
    returns the best permutation tuple.
    """
    x = torch.stack([torch.as_tensor(v) for v in xlist])
    s = torch.stack([torch.as_tensor(v) for v in slist]).to(x.device)
    num = x.shape[0]
    if num != s.shape[0]:
        raise RuntimeError(
            f"Source count mismatch: {num} vs {s.shape[0]}")
    # pairwise matrix in one shot: (est, ref)
    pair = si_snr(x[:, None, :], s[None, :, :]).cpu().numpy()
    perms = list(permutations(range(num)))
    scores = [np.mean([pair[i, p[i]] for i in range(num)]) for p in perms]
    best = int(np.argmax(scores))
    if align:
        return float(scores[best]), perms[best]
    return float(scores[best])
