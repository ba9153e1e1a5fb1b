"""The OM-LSA gain's frame recursion with the MCRA or iMCRA noise estimator.

Replaces no TPU kernel: the JAX package runs each estimator as one
``lax.scan`` over frames (setk_tpu/enhance/ns.py:147-219, :267-349) and
pins its command to the host.  Kernel source ``setk_tpu_torch/csrc/
omlsa.cu``:

  omlsa: power (L, T, F) f32 (|X|^2 of L rows) -> gains (L, T, F) f32.
      Only the gain's carry chain is serial; a call runs it as a thread a
      bin of a row looping over t, with its carries in registers and no
      barrier, and the cross-bin and output work in passes parallel over
      (row, frame, bin): MCRA 4 CUDA launches (the 'same' convolution of
      |X|^2, the chain, the frame level of each row, the gains), iMCRA 5
      (the convolution, the first smoothing's recursion, the indicator's
      two convolutions, the chain with the second smoothing, the gains).

CUDA C++ and not Triton: the heart of the work is a serial chain of T
frames a bin, with rings of windowed minima indexed at run time, not one
elementwise or reduction pass over a tensor.

``omlsa_plain`` is its plain version: the same recursion as a per-frame
PyTorch loop in the JAX module's order of operations (``exp1`` with the
A&S 5.1.53/5.1.56 coefficients, ``_conv_same``'s shifted-add chain), with
MCRA's frame mean summed in the kernel's order (32 lane-strided partial
sums in index order, then a halving tree over the 32).
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch

from setk_tpu_torch.dsp.window import make_window
from setk_tpu_torch.ops.cuda import _build

__all__ = ["exp1", "omlsa", "omlsa_plain", "omlsa_layout", "RESTART_PHASE"]

# MCRA's minimum tracking restarts at frames t with (t + 1) % L == 10
RESTART_PHASE = 10
# csrc/omlsa.cu's Params: the float fields, then the int fields, in order
_FLOAT_FIELDS = ("alpha", "alpha_c", "alpha_s", "alpha_s_c", "alpha_d",
                 "alpha_d_c", "xi_min", "gmin", "eps", "delta", "beta",
                 "beta_c", "alpha_p", "alpha_p_c", "zeta_min", "zeta_max",
                 "zeta_p_min", "zeta_p_max", "q_max", "log_ratio", "b_min",
                 "gamma0", "gamma1", "gamma1_c", "zeta0")
_INT_FIELDS = ("T", "F", "wm", "wg", "wl", "restart_L", "beg", "n_mean",
               "U", "V")


def exp1(x):
    """Exponential integral E1(x), x > 0: A&S 5.1.53 below 1, 5.1.56 above
    (|error| < 2e-7), setk_tpu/enhance/ns.py:32-53's statements."""
    x = torch.clamp(x, min=1e-12)
    small = (-torch.log(x) - 0.57721566 +
             x * (0.99999193 +
                  x * (-0.24991055 +
                       x * (0.05519968 +
                            x * (-0.00976004 + x * 0.00107857)))))
    p = (((x + 8.5733287401) * x + 18.059016973) * x +
         8.6347608925) * x + 0.2677737343
    q = (((x + 9.5733223454) * x + 25.6329561486) * x +
         21.0996530827) * x + 3.9584969228
    large = torch.exp(-x) / x * (p / q)
    return torch.where(x <= 1.0, small, large)


def _shift(x, shift):
    """seg[j] = x[j + shift] along the last axis, zero outside."""
    f = x.shape[-1]
    if shift == 0:
        return x
    if abs(shift) >= f:
        return torch.zeros_like(x)
    if shift > 0:
        return torch.nn.functional.pad(x[..., shift:], (0, shift))
    return torch.nn.functional.pad(x[..., :f + shift], (-shift, 0))


def _conv_same(x, w):
    """'same' convolution along the last axis as setk_tpu's shifted-add
    chain: out[j] = sum_i w[i] x[j + half - i], zero-padded, the terms
    added in order of i."""
    half = w.shape[0] // 2
    acc = None
    for i in range(w.shape[0]):
        term = w[i] * _shift(x, half - i)
        acc = term if acc is None else acc + term
    return acc


def _frame_mean(z):
    """Mean over the last axis in the kernel's order: lane l of a warp
    sums z[l], z[l + 32], ... in index order, then the 32 partials meet in
    a halving tree (element i + h into element i), then / n."""
    n = z.shape[-1]
    k = -(-n // 32)
    zp = torch.nn.functional.pad(z, (0, 32 * k - n)).reshape(
        *z.shape[:-1], k, 32)
    acc = zp[..., 0, :]
    for i in range(1, k):
        acc = acc + zp[..., i, :]
    for h in (16, 8, 4, 2, 1):
        acc = acc[..., :h] + acc[..., h:2 * h]
    return acc[..., 0] / n


def _window(name, width, device):
    # periodic, as scipy.signal.get_window: the 3-tap hann is [0, .75, .75]
    return torch.as_tensor(make_window(name, width), device=device)


def _mcra_plain(pw, cfg, eps):
    l_rows, t_frames, f = pw.shape
    dev = pw.device
    w_m = _window(cfg.h_mcra, cfg.w_mcra * 2 + 1, dev)
    w_g = _window(cfg.h_global, cfg.w_global * 2 + 1, dev)
    w_l = _window(cfg.h_local, cfg.w_local * 2 + 1, dev)
    gmin = 10**(cfg.gmin_db / 10)
    xi_min = 10**(cfg.xi_min_db / 10)
    zeta_min = 10**(cfg.zeta_min_db / 10)
    zeta_max = 10**(cfg.zeta_max_db / 10)
    zeta_p_min = 10**(cfg.zeta_p_min_db / 10)
    zeta_p_max = 10**(cfg.zeta_p_max_db / 10)
    log_ratio = float(np.log10(zeta_max / zeta_min))
    n_mean = min(cfg.M // 2 + 1, f)

    def interp_db(z):
        """eq.25 piecewise soft decision in [0, 1]."""
        frac = torch.log10(torch.clamp(z, min=1e-20) / zeta_min) / log_ratio
        return torch.where(z >= zeta_max, 1.0,
                           torch.where(z > zeta_min, frac, 0.0))

    ones = torch.ones((l_rows, f), device=dev)
    gh1, p_hat, zeta = ones, ones, ones
    zeta_peak = torch.zeros(l_rows, device=dev)
    zeta_frame_pre = zeta_peak
    lam = pw[:, 0]
    var_s = var_s_min = var_s_tmp = torch.zeros_like(ones)
    gains = torch.empty_like(pw)
    for t in range(t_frames):
        x = pw[:, t]
        first = t == 0
        # eq.10: a posteriori SNR; eq.18: a priori SNR (decision-directed)
        gamma = torch.clamp(x / torch.clamp(lam, min=eps), min=eps)
        xi_hat = (cfg.alpha * gh1**2 * gamma +
                  (1 - cfg.alpha) * torch.clamp(gamma - 1, min=0))
        xi_hat = torch.clamp(xi_hat, min=xi_min)
        # eq.15: LSA gain under speech presence
        v = gamma * xi_hat / (1 + xi_hat)
        gh1 = xi_hat * torch.exp(0.5 * exp1(v)) / (1 + xi_hat)
        # eq.32-33: smoothed power
        var_sf = _conv_same(x, w_m)
        var_s = x if first else (cfg.alpha_s * var_s +
                                 (1 - cfg.alpha_s) * var_sf)
        # eq.34-37: minima tracking with an L-frame restart at phase 10
        if first:
            var_s_min = var_s_tmp = var_s
        elif (t + 1) % cfg.L == RESTART_PHASE:
            var_s_min = torch.minimum(var_s_tmp, var_s)
            var_s_tmp = var_s
        else:
            var_s_min = torch.minimum(var_s_min, var_s)
            var_s_tmp = torch.minimum(var_s_tmp, var_s)
        # eq.39-40: speech presence indicator -> probability
        sr_ind = (var_s / torch.clamp(var_s_min, min=eps)) > cfg.delta
        p_hat = cfg.alpha_p * p_hat + (1 - cfg.alpha_p) * sr_ind.to(
            pw.dtype)
        # eq.30-31: noise spectrum update
        alpha_d_hat = cfg.alpha_d + (1 - cfg.alpha_d) * p_hat
        lam = alpha_d_hat * lam + (1 - alpha_d_hat) * x
        # eq.23-25: a priori speech absence via smoothed xi
        zeta = cfg.beta * zeta + (1 - cfg.beta) * xi_hat
        var_p_g = interp_db(_conv_same(zeta, w_g))
        var_p_l = interp_db(_conv_same(zeta, w_l))
        # eq.26-27: frame-level decision
        zeta_frame = _frame_mean(zeta[:, :n_mean])
        if first:
            zeta_frame_pre = zeta_frame
        rising = zeta_frame > zeta_frame_pre
        zeta_peak = torch.where(
            (zeta_frame > zeta_min) & rising,
            torch.clamp(zeta_frame, zeta_p_min, zeta_p_max), zeta_peak)
        p_frame_soft = (torch.log10(torch.clamp(
            zeta_frame / torch.clamp(zeta_min * zeta_peak, min=1e-20),
            min=1e-20)) / log_ratio)
        p_frame = torch.where(
            zeta_frame <= zeta_min, 0.0,
            torch.where(
                rising, 1.0,
                torch.where(
                    zeta_frame <= zeta_min * zeta_peak, 0.0,
                    torch.where(zeta_frame >= zeta_max * zeta_peak, 1.0,
                                p_frame_soft))))
        # eq.28: a priori speech absence
        q_hat = torch.clamp(1 - var_p_l * p_frame[:, None] * var_p_g,
                            max=cfg.q_max)
        # eq.9: speech presence probability; eq.16: OM-LSA gain
        p_inv = 1 + q_hat * (1 + xi_hat) * torch.exp(-v) / torch.clamp(
            1 - q_hat, min=eps)
        p = 1 / p_inv
        gains[:, t] = gh1**p * gmin**(1 - p)
        zeta_frame_pre = zeta_frame
    return gains


def _imcra_plain(pw, cfg, eps):
    l_rows, t_frames, f = pw.shape
    dev = pw.device
    w_m = _window(cfg.h_mcra, cfg.w_mcra * 2 + 1, dev)
    b_min = 1 / cfg.b_min
    xi_min = 10**(cfg.xi_min_db / 10)
    gain_min = 10**(cfg.gmin_db / 10)
    gh1 = torch.ones((l_rows, f), device=dev)
    lam = pw[:, 0]
    zeros = torch.zeros_like(gh1)
    var_s = var_s_hat = var_s_min = var_s_min_sw = zeros
    var_s_min_hat = var_s_min_sw_hat = zeros
    ring_sw = torch.zeros((l_rows, cfg.U, f), device=dev)
    ring_sw_hat = torch.zeros_like(ring_sw)
    gains = torch.empty_like(pw)
    for t in range(t_frames):
        x = pw[:, t]
        first = t == 0
        lambda_d = lam * cfg.beta
        # eq.3 a posteriori SNR; eq.32 a priori SNR
        gamma = x / torch.clamp(lambda_d, min=eps)
        xi_hat = (cfg.alpha * gh1**2 * gamma +
                  (1 - cfg.alpha) * torch.clamp(gamma - 1, min=0))
        xi_hat = torch.clamp(xi_hat, min=xi_min)
        # eq.33
        v = gamma * xi_hat / (1 + xi_hat)
        gh1 = xi_hat / (1 + xi_hat) * torch.exp(0.5 * exp1(v))
        # eq.14-15: first smoothing + minima
        var_sf = _conv_same(x, w_m)
        if first:
            var_s = var_s_min = var_s_min_sw = var_sf
        else:
            var_s = cfg.alpha_s * var_s + (1 - cfg.alpha_s) * var_sf
            var_s_min = torch.minimum(var_s_min, var_s)
            var_s_min_sw = torch.minimum(var_s_min_sw, var_s)
        # eq.21: rough speech-absence indicator
        gamma_min = x * b_min / torch.clamp(var_s_min, min=eps)
        zeta = var_sf * b_min / torch.clamp(var_s_min, min=eps)
        indicator = ((gamma_min < cfg.gamma0) & (zeta < cfg.zeta0)).to(
            pw.dtype)
        # eq.26: indicator-gated second smoothing
        ind_conv = _conv_same(indicator, w_m)
        obs_conv = _conv_same(x * indicator, w_m)
        var_sf_hat = torch.where(ind_conv > 0,
                                 obs_conv / torch.clamp(ind_conv, min=eps),
                                 var_s_hat)
        if first:
            var_s_hat = var_sf
            var_s_min_hat = var_s
            var_s_min_sw_hat = var_sf
        else:
            var_s_hat = cfg.alpha_s * var_s_hat + (
                1 - cfg.alpha_s) * var_sf_hat
            var_s_min_hat = torch.minimum(var_s_min_hat, var_s_hat)
            var_s_min_sw_hat = torch.minimum(var_s_min_sw_hat, var_s_hat)
        # eq.28-29: refined indicators -> a priori absence probability
        gamma_min_hat = x * b_min / torch.clamp(var_s_min_hat, min=eps)
        zeta_hat = var_s * b_min / torch.clamp(var_s_min_hat, min=eps)
        qhat_band = (gamma_min_hat > 1) & (gamma_min_hat < cfg.gamma1) & (
            zeta_hat < cfg.zeta0)
        q_hat = torch.where(qhat_band,
                            (cfg.gamma1 - gamma_min_hat) / (cfg.gamma1 - 1),
                            0.0)
        # eq.7: speech presence probability
        p_den = 1 + q_hat * (1 + xi_hat) / torch.clamp(
            1 - q_hat, min=eps) * torch.exp(-v)
        p_hat = torch.where(qhat_band, 1 / p_den, 0.0)
        p_hat = torch.where(
            (gamma_min_hat >= cfg.gamma1) & (zeta_hat >= cfg.zeta0), 1.0,
            p_hat)
        # eq.10-11: noise estimate update
        alpha_d_hat = cfg.alpha_d + (1 - cfg.alpha_d) * p_hat
        lam = alpha_d_hat * lam + (1 - alpha_d_hat) * x
        # the ring of windowed minima; a V-frame boundary restarts the
        # sliding windows from the last min(t + 1, U) slots
        slot = t % cfg.U
        ring_sw[:, slot] = var_s_min_sw
        ring_sw_hat[:, slot] = var_s_min_sw_hat
        if (t + 1) % cfg.V == 0:
            valid = min(t + 1, cfg.U)
            var_s_min = ring_sw[:, :valid].amin(1)
            var_s_min_hat = ring_sw_hat[:, :valid].amin(1)
            var_s_min_sw = var_s
            var_s_min_sw_hat = var_s_hat
        gains[:, t] = gh1**p_hat * gain_min**(1 - p_hat)
    return gains


def _check_estimator(estimator):
    if estimator not in ("mcra", "imcra"):
        raise ValueError(f"Unknown noise estimator: {estimator}")


def omlsa_plain(power: torch.Tensor, estimator: str, cfg,
                eps: float = 1e-7) -> torch.Tensor:
    """Plain version of the OM-LSA kernel: power (L, T, F) f32 -> gains
    (L, T, F) f32 for ``estimator`` 'mcra' (``cfg`` an MCRAConfig) or
    'imcra' (an IMCRAConfig)."""
    _check_estimator(estimator)
    if power.ndim != 3 or power.shape[1] < 1:
        raise ValueError(f"omlsa: power must be (L, T >= 1, F), got "
                         f"{tuple(power.shape)}")
    run = _mcra_plain if estimator == "mcra" else _imcra_plain
    return run(power, cfg, eps)


def _f32(x):
    return float(np.float32(x))


def _params(estimator, cfg, eps, t_frames, f):
    """The kernel's scalar arguments, each computed as the plain version
    computes it (in double on the host) and rounded to f32 once; and its
    window taps, w_m then (MCRA) w_g and w_l."""
    fl = dict.fromkeys(_FLOAT_FIELDS, 0.0)
    it = dict.fromkeys(_INT_FIELDS, 0)
    fl.update(alpha=cfg.alpha, alpha_c=1 - cfg.alpha, alpha_s=cfg.alpha_s,
              alpha_s_c=1 - cfg.alpha_s, alpha_d=cfg.alpha_d,
              alpha_d_c=1 - cfg.alpha_d, xi_min=10**(cfg.xi_min_db / 10),
              gmin=10**(cfg.gmin_db / 10), eps=eps, beta=cfg.beta)
    it.update(T=t_frames, F=f, wm=cfg.w_mcra * 2 + 1)
    taps = [make_window(cfg.h_mcra, cfg.w_mcra * 2 + 1)]
    if estimator == "mcra":
        zeta_min = 10**(cfg.zeta_min_db / 10)
        zeta_max = 10**(cfg.zeta_max_db / 10)
        fl.update(delta=cfg.delta, beta_c=1 - cfg.beta, alpha_p=cfg.alpha_p,
                  alpha_p_c=1 - cfg.alpha_p, zeta_min=zeta_min,
                  zeta_max=zeta_max, zeta_p_min=10**(cfg.zeta_p_min_db / 10),
                  zeta_p_max=10**(cfg.zeta_p_max_db / 10), q_max=cfg.q_max,
                  log_ratio=np.log10(zeta_max / zeta_min))
        it.update(wg=cfg.w_global * 2 + 1, wl=cfg.w_local * 2 + 1,
                  restart_L=cfg.L, beg=RESTART_PHASE,
                  n_mean=min(cfg.M // 2 + 1, f))
        taps += [make_window(cfg.h_global, it["wg"]),
                 make_window(cfg.h_local, it["wl"])]
    else:
        if cfg.U < 1 or cfg.V < 1:
            raise ValueError(f"imcra: U and V must be >= 1, got U = {cfg.U}, "
                             f"V = {cfg.V}")
        fl.update(b_min=1 / cfg.b_min, gamma0=cfg.gamma0, gamma1=cfg.gamma1,
                  gamma1_c=cfg.gamma1 - 1, zeta0=cfg.zeta0)
        it.update(U=cfg.U, V=cfg.V)
    floats = (ctypes.c_float * len(_FLOAT_FIELDS))(
        *[_f32(fl[k]) for k in _FLOAT_FIELDS])
    ints = (ctypes.c_int * len(_INT_FIELDS))(*[int(it[k])
                                               for k in _INT_FIELDS])
    return floats, ints, np.concatenate(taps).astype(np.float32)


@lru_cache(maxsize=32)
def _taps_on(taps: bytes, device: torch.device) -> torch.Tensor:
    # one host-to-device copy a configuration and device, not one a call
    return torch.as_tensor(np.frombuffer(taps, np.float32).copy(),
                           device=device)


_LAYOUTS = {}


def omlsa_layout(estimator: str, f: int, u: int, ntaps: int,
                 device=None) -> dict:
    """The launch ``csrc/omlsa.cu`` takes for F bins (U windowed minima,
    ``ntaps`` window taps), once a device and configuration: threads a
    block and blocks a row of the loops over t, scratch floats a row and
    frame and a row besides (the rings of windowed minima, where they do
    not fit in shared memory), the rings in shared memory, and the CUDA
    launches a call."""
    device = torch.device(device if device is not None else "cuda")
    key = (device.index, estimator, f, u, ntaps)
    if key not in _LAYOUTS:
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            _build.check(_build.library("omlsa").omlsa_layout(
                int(estimator == "imcra"), f, u, ntaps,
                ctypes.addressof(out)), "omlsa_layout")
        _LAYOUTS[key] = dict(zip(
            ("threads", "blocks_a_row", "floats_a_frame", "floats_a_row",
             "ring_shared", "launches"), out))
    return _LAYOUTS[key]


def omlsa(power: torch.Tensor, estimator: str, cfg,
          eps: float = 1e-7) -> torch.Tensor:
    """The OM-LSA kernel: gains (L, T, F) f32 of power (L, T, F) f32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernels, any F >= 1 and T >= 1 (``omlsa.launches`` counts calls: one
    a call, of 4 CUDA launches for MCRA and 5 for iMCRA).  The scratch
    (``torch.empty``) holds the intermediates the passes hand on, each an
    (L, T, F) f32 array, MCRA 4 and iMCRA 6 of them: ~0.5 MB an array at
    one 8 s utterance (T = 501, F = 257), ~66 MB at L = 128.
    """
    _check_estimator(estimator)
    if power.device.type == "cpu":
        return omlsa_plain(power, estimator, cfg, eps)
    if power.dtype != torch.float32 or power.ndim != 3 or \
            not power.is_contiguous() or 0 in power.shape:
        raise ValueError(f"omlsa: power must be a contiguous non-empty "
                         f"float32 (L, T, F) CUDA tensor, got {power.dtype} "
                         f"{tuple(power.shape)}")
    rows, t_frames, f = power.shape
    floats, ints, taps = _params(estimator, cfg, eps, t_frames, f)
    taps_d = _taps_on(taps.tobytes(), power.device)
    layout = omlsa_layout(estimator, f, ints[_INT_FIELDS.index("U")],
                          taps.size, power.device)
    scratch = torch.empty(
        max(rows * (t_frames * layout["floats_a_frame"] +
                    layout["floats_a_row"]), 1),
        dtype=torch.float32, device=power.device)
    gain = torch.empty_like(power)
    _build.launch("omlsa", "omlsa_launch", power.device, power.data_ptr(),
                  gain.data_ptr(), taps_d.data_ptr(), scratch.data_ptr(),
                  ctypes.addressof(floats), ctypes.addressof(ints), rows,
                  int(estimator == "imcra"))
    omlsa.launches += 1
    return gain


omlsa.launches = 0
