"""Sound-source localization: ML, SRP-PHAT and MUSIC.

Counterpart of ``setk_tpu/spatial/ssl.py`` (the reference toolkit's
scripts/sptk/libs/ssl.py), on the device the STFT lies on.  Layouts as
the CLIs give them: stft (M, T, F), steering grid sv (A, M, F), masks
(T, F) or (N, T, F).  Each backend returns the DoA index (and with
``return_scores`` the scores over the grid).  MUSIC's per-bin EVD is
``ops.linalg.eigh``: on a CUDA tensor the EVD kernel, one launch for
all F bins.
"""

import torch

from setk_tpu_torch.ops.linalg import eigh

__all__ = ["ml_ssl", "srp_ssl", "music_ssl"]


def ml_ssl(stft: torch.Tensor,
           sv: torch.Tensor,
           compression: float = 0,
           eps: float = 1e-8,
           norm: bool = False,
           mask: torch.Tensor | None = None,
           return_scores: bool = False):
    """Maximum-likelihood SSL.

    Per-TF log-likelihood of each steering direction, mask-weighted and
    summed; multi-source masks (N, T, F) give one DoA per source.
    """
    _, t, f = stft.shape
    if mask is None:
        mask = torch.ones((t, f), device=stft.device)
    sv = sv / torch.linalg.vector_norm(sv, dim=1, keepdim=True)
    if norm:
        stft = stft / torch.clamp(stft.abs(), min=eps)
    ssh = (stft * stft.conj()).sum(0).abs()
    # (F, A, M) x (F, M, T): one batched product over the bins
    ssv = (sv.permute(2, 0, 1) @ stft.conj().permute(2, 0, 1)).abs()**2
    delta = ssh[None] - ssv.permute(1, 2, 0) / (1 + eps)
    if compression <= 0:
        tf_loglike = -torch.log(torch.clamp(delta, min=eps))
    else:
        tf_loglike = -torch.pow(delta, compression)
    if mask.ndim == 2:
        loglike = (mask[None] * tf_loglike).sum((1, 2))
    else:
        loglike = torch.einsum("ntf,atf->na", mask, tf_loglike)
    idx = torch.argmax(loglike, dim=-1)
    return (idx, loglike) if return_scores else idx


def srp_ssl(stft: torch.Tensor,
            sv: torch.Tensor,
            srp_pair,
            mask: torch.Tensor | None = None,
            return_scores: bool = False):
    """SRP-PHAT SSL over explicit mic index pairs (index_l, index_r).

    The sum over pairs and the masked (T, F) plane of cos(obs - ora) is
    taken through cos(x - y) = cos x cos y + sin x sin y with the T
    reduction first: P x T x F cosines and sines, then one (A, P F)
    product, never the (A, P, T, F) broadcast.
    """
    if srp_pair is None:
        raise ValueError("srp_pair cannot be None, (list, list)")
    _, t, f = stft.shape
    if mask is None:
        mask = torch.ones((t, f), device=stft.device)
    index_l = torch.as_tensor(srp_pair[0], device=stft.device)
    index_r = torch.as_tensor(srp_pair[1], device=stft.device)
    obs_pha = stft.angle()
    ora_pha = sv.angle()
    obs_ipd = obs_pha[index_l] - obs_pha[index_r]          # P x T x F
    ora_ipd = ora_pha[:, index_l] - ora_pha[:, index_r]    # A x P x F
    co = (torch.cos(obs_ipd) * mask[None]).sum(1)          # P x F
    si = (torch.sin(obs_ipd) * mask[None]).sum(1)          # P x F
    a = ora_ipd.shape[0]
    srp = (torch.cos(ora_ipd).reshape(a, -1) @ co.reshape(-1) +
           torch.sin(ora_ipd).reshape(a, -1) @ si.reshape(-1)) / \
        index_l.shape[0]
    idx = torch.argmax(srp)
    return (idx, srp) if return_scores else idx


def music_ssl(stft: torch.Tensor,
              sv: torch.Tensor,
              mask: torch.Tensor | None = None,
              return_scores: bool = False):
    """MUSIC: the noise subspace's orthogonality to each steer vector.

    The observation is weighted by the mask before the Gram, so the
    covariance carries mask^2, normalized by T (the JAX package's
    semantics).  The noise projector V[:, :-1] V[:, :-1]^H needs the
    eigenvalues ascending and does not depend on the eigenvectors'
    phases.
    """
    _, t, f = stft.shape
    if mask is None:
        mask = torch.ones((t, f), device=stft.device)
    obs = (stft * mask).permute(2, 0, 1)                    # F x M x T
    covar = obs @ obs.conj().transpose(-1, -2) / t
    _, vecs = eigh(covar)
    noise_sub = vecs[..., :-1]
    noise_covar = noise_sub @ noise_sub.conj().transpose(-1, -2)
    sv_f = sv.permute(2, 0, 1)                              # F x A x M
    denorm = ((sv_f.conj() @ noise_covar) * sv_f).sum(-1)   # F x A
    score = denorm.abs().sum(0)
    idx = torch.argmin(score)
    return (idx, score) if return_scores else idx
