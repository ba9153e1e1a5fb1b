"""Masked covariance pair from materialized spectra (kernels 11 and 12).

Counterpart of ``setk_tpu/ops/pallas/covariance_pair.py``'s
``pair_covar_complement_pallas`` (:105) and ``pair_covar_pallas`` (:139);
kernel source ``setk_tpu_torch/csrc/covariance_pair.cu``, one templated
kernel for both:

  pair_covar_complement: obs as re, im planes (B, N, T, F) f32 and the
      speech mask (B, T, F) -> the numerators of Rs (mask m) and Rn
      (mask max(1 - m, 0) over the first ``n_valid_t`` frames, 0 after);
  pair_covar: obs (B, N, T, F) complex64 and two masks (B, T, F).

Both return four (B, N, N, F) f32 planes (rs_re, rs_im, rn_re, rn_im),
unnormalized and Hermitian-filled.  Each mask multiplies the pair
product before the sum over frames (Rn is never total minus masked).
The masks need only a unit stride along F, so a caller may pass the
first columns of a wider mask without a copy.  N <= 8, any T and F (the
TPU kernel's F padding to 128 lanes does not apply).  Each kernel has a
plain PyTorch version of the same function beside it.
"""

import torch

from setk_tpu_torch.ops.cuda import _build

__all__ = ["MAX_MICS", "pair_covar_complement", "pair_covar_complement_plain",
           "pair_covar", "pair_covar_plain"]

MAX_MICS = 8


def _pair_planes(obs: torch.Tensor, mask_s: torch.Tensor,
                 mask_n: torch.Tensor):
    """(B,N,T,F) complex, two (B,T,F) masks -> four (B,N,N,F) planes."""
    o = obs.permute(0, 3, 1, 2)                       # (B, F, N, T)
    oh = o.conj().transpose(-1, -2)

    def planes(m):
        num = (o * m.to(torch.float32).transpose(1, 2)[:, :, None, :]) @ oh
        num = num.permute(0, 2, 3, 1)                 # (B, N, N, F)
        return num.real.contiguous(), num.imag.contiguous()

    return (*planes(mask_s), *planes(mask_n))


def pair_covar_complement_plain(obs_re: torch.Tensor, obs_im: torch.Tensor,
                                mask_s: torch.Tensor, n_valid_t: int):
    """Plain version of kernel 11."""
    t = obs_re.shape[2]
    valid = (torch.arange(t, device=obs_re.device) < n_valid_t).to(
        torch.float32)[:, None]
    mask_n = torch.clamp(1.0 - mask_s.to(torch.float32), min=0.0) * valid
    return _pair_planes(torch.complex(obs_re, obs_im), mask_s, mask_n)


def pair_covar_plain(obs: torch.Tensor, mask_s: torch.Tensor,
                     mask_n: torch.Tensor):
    """Plain version of kernel 12."""
    return _pair_planes(obs, mask_s, mask_n)


def _check_masks(fn, shape, dev, *masks):
    """(batch stride, frame stride) shared by the masks, which must be
    float32 (B, T, F) on ``dev`` with a unit stride along F."""
    b, t, f = shape
    strides = {m.stride() for m in masks}
    for m in masks:
        if m.device != dev or m.dtype != torch.float32 or \
                tuple(m.shape) != (b, t, f) or m.stride(-1) != 1:
            raise ValueError(f"{fn}: masks must be float32 {(b, t, f)} "
                             f"tensors on {dev} with unit stride along F; "
                             f"got {m.dtype} {tuple(m.shape)} strides "
                             f"{m.stride()} on {m.device}")
    if len(strides) != 1:
        raise ValueError(f"{fn}: the two masks must share their strides")
    bstride, tstride, _ = strides.pop()
    # a stride along an axis of one element is free
    if t == 1:
        tstride = max(tstride, f)
    if b == 1:
        bstride = max(bstride, (t - 1) * tstride + f)
    if tstride < f or bstride < (t - 1) * tstride + f:
        raise ValueError(f"{fn}: overlapping mask strides {(bstride, tstride)}")
    return bstride, tstride


def _check_obs(fn, x, dtype):
    if x.device.type != "cuda" or x.dtype != dtype or x.ndim != 4 or \
            not x.is_contiguous() or 0 in x.shape:
        raise ValueError(f"{fn}: obs must be a contiguous non-empty {dtype} "
                         f"(B, N, T, F) CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if x.shape[1] > MAX_MICS:
        raise ValueError(f"{fn}: N = {x.shape[1]} > {MAX_MICS}")
    return x.shape


def _launch(fn, dev, shape, re_ptr, im_ptr, es, mask_s, mask_n, strides,
            n_valid_t, complement):
    b, n, t, f = shape
    out = [torch.empty((b, n, n, f), dtype=torch.float32, device=dev)
           for _ in range(4)]
    _build.launch("covariance_pair", "pair_covar_launch", dev, re_ptr,
                  im_ptr, es, mask_s.data_ptr(),
                  None if mask_n is None else mask_n.data_ptr(), *strides,
                  *(x.data_ptr() for x in out), b, n, t, f, n_valid_t,
                  int(complement))
    fn.launches += 1
    return tuple(out)


def pair_covar_complement(obs_re: torch.Tensor, obs_im: torch.Tensor,
                          mask_s: torch.Tensor, n_valid_t: int):
    """Kernel 11: (rs_re, rs_im, rn_re, rn_im) numerator planes, mask_n =
    max(1 - mask_s, 0) on the first ``n_valid_t`` frames.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``pair_covar_complement.launches`` counts those launches).
    """
    if obs_re.device.type == "cpu":
        return pair_covar_complement_plain(obs_re, obs_im, mask_s, n_valid_t)
    shape = _check_obs("pair_covar_complement", obs_re, torch.float32)
    if obs_im.shape != shape or obs_im.device != obs_re.device or \
            obs_im.dtype != torch.float32 or not obs_im.is_contiguous():
        raise ValueError("pair_covar_complement: re and im must be "
                         "contiguous float32 planes of one shape and device")
    b, _, t, f = shape
    strides = _check_masks("pair_covar_complement", (b, t, f), obs_re.device,
                           mask_s)
    return _launch(pair_covar_complement, obs_re.device, shape,
                   obs_re.data_ptr(), obs_im.data_ptr(), 1, mask_s, None,
                   strides, n_valid_t, True)


def pair_covar(obs: torch.Tensor, mask_s: torch.Tensor,
               mask_n: torch.Tensor):
    """Kernel 12: (rs_re, rs_im, rn_re, rn_im) numerator planes of
    complex64 obs (B, N, T, F) read interleaved, with two masks.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``pair_covar.launches`` counts those launches).
    """
    if obs.device.type == "cpu":
        return pair_covar_plain(obs, mask_s, mask_n)
    shape = _check_obs("pair_covar", obs, torch.complex64)
    b, _, t, f = shape
    strides = _check_masks("pair_covar", (b, t, f), obs.device, mask_s,
                           mask_n)
    # re at even, im at odd floats of the interleaved complex64 storage
    return _launch(pair_covar, obs.device, shape, obs.data_ptr(),
                   obs.data_ptr() + 4, 2, mask_s, mask_n, strides, t, False)


for _fn in (pair_covar_complement, pair_covar):
    _fn.launches = 0
