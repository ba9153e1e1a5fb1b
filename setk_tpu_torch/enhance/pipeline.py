"""The fused enhancement pipeline (the main path on the card).

Counterpart of ``setk_tpu/enhance/pipeline.py: enhance_fused``
(pipeline.py:60-196) for the supervised family in ``FUSED_BEAMFORMERS``,
with or without BAN: kernel A (ops/cuda/fused_mvdr.stft_covar) emits
the Rs/Rn numerators with no spectrum in device memory, a per-bin solve
kernel (ops/cuda/mvdr: mvdr_power, gevd_power, pmwf_solve, capon) gives
the weights, and kernel B (fused_mvdr.beamform_istft) recomputes the DFT
to beamform and resynthesize.  Kernels A and B do not depend on the
weights.  Bins stay in natural order.  ``enhance_plain`` runs the same
steps through the kernels' plain versions on any device; it is what the
kernels are held against.

``mvdr_enhance_fused_online`` is the online (chunked EMA) MVDR,
counterpart of setk_tpu/enhance/pipeline.py:293-348: kernel A per chunk,
the EMA kernel, ``mvdr_power`` on every chunk's state and the online
kernel B; ``enhance_plain_online`` is its plain twin.

``mvdr_enhance_planar`` is MVDR for the STFT geometries outside the
fused gate (other n_fft, hops and lengths), counterpart of
setk_tpu/enhance/pipeline.py:199-283: the planar STFT kernel writes the
spectrum as re/im planes plus the Nyquist bin, the pair-covariance kernel
forms the Rs/Rn numerators of bins 0 .. n_fft/2 - 1 from them,
``mvdr_power`` solves every bin, and after a beamform pass the planar
iSTFT kernel resynthesizes (center framing; without center the port's
``inverse_stft`` does, as in the JAX package).  The Nyquist bin's
covariances and the beamform are plain tensor code between the kernels.
``mvdr_enhance_planar_plain`` is its plain twin.
"""

import functools
import typing

import torch

from setk_tpu_torch.dsp.stft import StftConfig, inverse_stft
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.ops.cuda import planar as pl
from setk_tpu_torch.utils.device import full_f32_matmuls

__all__ = ["FUSED_BEAMFORMERS", "fused_supported", "check_fused_options",
           "enhance_fused", "enhance_plain", "fused_online_supported",
           "mvdr_enhance_fused_online", "enhance_plain_online",
           "planar_supported", "mvdr_enhance_planar",
           "mvdr_enhance_planar_plain"]

# the beamformers the fused kernel pair serves: only the small per-bin
# weight solve differs between them
FUSED_BEAMFORMERS = ("mvdr", "gevd", "pmwf-0", "pmwf-1", "mpdr",
                     "mpdr-whiten")


def fused_supported(cfg: StftConfig, num_mics: int, nsamps: int,
                    out_samps: int) -> bool:
    """The port's gate for the fused kernels: n_fft 512, hop 256,
    center, N <= 8, S % 256 == 0, S >= 512 and out_samps == (T-1)*256.
    Any frame count T (the TPU's T <= 512 cap does not apply)."""
    if not (cfg.n_fft == fm.NFFT and cfg.frame_hop == fm.HOP and cfg.center
            and fm.fused_geometry_ok(num_mics, nsamps)):
        return False
    return out_samps == (cfg.num_frames(nsamps) - 1) * fm.HOP


def fused_online_supported(cfg: StftConfig, num_mics: int, nsamps: int,
                           out_samps: int, chunk: int) -> bool:
    """The online kernels' gate: the fused geometry and any chunk >= 1
    (the TPU's 8 <= chunk, 128 % chunk == 0 and T <= 512 do not apply)."""
    return chunk >= 1 and fused_supported(cfg, num_mics, nsamps, out_samps)


@functools.lru_cache(maxsize=64)
def _constants(cfg: StftConfig, n_frames: int, out_samps: int,
               device: torch.device):
    """The analysis window and the reciprocal window-sum-square of the
    center-trimmed signal (flat, whole hop blocks of the samples that
    carry signal; n_fft = 2 hop) on ``device``, built once per shape: a
    host-to-device copy from pageable memory waits for the work already
    queued on the card, so building them per call would serialize
    consecutive batches.  Callers never write to them."""
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=device)
    wss_inv = torch.as_tensor(
        pl.istft_wss_inverse(cfg.padded_window, n_frames, out_samps),
        device=device)
    return window, wss_inv


class _Ops(typing.NamedTuple):
    """The functions one run goes through: the kernels or their plain
    versions."""
    stft_covar: typing.Callable
    mvdr_power: typing.Callable
    gevd_power: typing.Callable
    pmwf_solve: typing.Callable
    capon: typing.Callable
    beamform_istft: typing.Callable
    stft_covar_chunks: typing.Callable
    covar_ema: typing.Callable
    beamform_istft_online: typing.Callable
    stft_planar: typing.Callable
    pair_covar_complement: typing.Callable
    istft_planar: typing.Callable


_KERNELS = _Ops(fm.stft_covar, mv.mvdr_power, mv.gevd_power, mv.pmwf_solve,
                mv.capon, fm.beamform_istft, fm.stft_covar_chunks,
                fm.covar_ema, fm.beamform_istft_online, pl.stft_planar,
                cp.pair_covar_complement, pl.istft_planar)
_PLAIN = _Ops(fm.stft_covar_plain, mv.mvdr_power_plain, mv.gevd_power_plain,
              mv.pmwf_solve_plain, mv.capon_plain, fm.beamform_istft_plain,
              fm.stft_covar_chunks_plain, fm.covar_ema_plain,
              fm.beamform_istft_online_plain, pl.stft_planar_plain,
              cp.pair_covar_complement_plain, pl.istft_planar_plain)


def _weights(ops: _Ops, beamformer, rs, rn, ry, power_iters):
    """The per-bin weight solve of each fused beamformer
    (setk_tpu/enhance/pipeline.py:133-179, iteration counts included);
    ``ry()`` gives the observation PSD for the mpdr pair."""
    if beamformer == "mvdr":
        return ops.mvdr_power(rs, rn, power_iters=power_iters)
    if beamformer == "gevd":
        return ops.gevd_power(rs, rn, power_iters=30)
    if beamformer in ("pmwf-0", "pmwf-1"):
        wm, ps, pn = ops.pmwf_solve(
            rs, rn, beta=0.0 if beamformer == "pmwf-0" else 1.0,
            return_powers=True)
        return bf.pmwf_select_powers(wm, ps, pn)
    if beamformer == "mpdr":
        # steer from Rs by power iteration, Capon on Ry: the MVDR solve
        # with Ry in Rn's place
        return ops.mvdr_power(rs, ry(), power_iters=power_iters)
    # mpdr-whiten: the whitened GEV steer Rn g, then Capon on Ry
    g = ops.gevd_power(rs, rn, power_iters=50)
    steer = bf.fix_steer_phase((rn * g[..., None, :]).sum(-1))
    return ops.capon(steer.contiguous(), ry())


def _prepare(wav, mask_s, cfg, nsamps):
    """Gate check, then (T, window, wss_inv, contiguous f32 mask)."""
    b, n, s = wav.shape
    out_samps = nsamps if nsamps is not None else s
    if not fused_supported(cfg, n, s, out_samps):
        raise ValueError(f"wav {tuple(wav.shape)} with out_samps "
                         f"{out_samps} is outside the fused kernels' gate")
    t = cfg.num_frames(s)
    window, wss_inv = _constants(cfg, t, out_samps, wav.device)
    return (t, window, wss_inv.view(-1, fm.HOP),
            mask_s.to(torch.float32).contiguous())


def _run(wav, mask_s, cfg, beamformer, ban, power_iters, nsamps,
         ops: _Ops):
    t, window, wss_inv, mask = _prepare(wav, mask_s, cfg, nsamps)
    rs_num, rn_num = ops.stft_covar(wav, mask, window)   # (B, F, N, N)
    den_s = mask.sum(dim=1)                              # (B, F)
    den_n = t - den_s
    rs = rs_num / torch.clamp(den_s, min=1e-6)[..., None, None]
    rn = rn_num / torch.clamp(den_n, min=1e-6)[..., None, None]
    # the numerators sum to sum_t y y^H over the valid frames
    w = _weights(ops, beamformer, rs, rn, lambda: (rs_num + rn_num) / t,
                 power_iters)                            # (B, F, N)
    if ban:
        w = bf.do_ban(w, rn)
    return ops.beamform_istft(wav, w.contiguous(), wss_inv, window)


def check_fused_options(beamformer: str, steer: str) -> None:
    """Raise on what the fused pipeline does not run: an unknown
    beamformer, or the eigh steer for mvdr."""
    if beamformer not in FUSED_BEAMFORMERS:
        raise ValueError(f"Unsupported fused beamformer: {beamformer}")
    if beamformer == "mvdr" and steer != "power":
        raise NotImplementedError(
            "the fused pipeline's eigh steer for mvdr arrives with the "
            "batched small-matrix EVD kernel, ROADMAP queue 1 item 13")


def enhance_fused(wav: torch.Tensor,
                  mask_s: torch.Tensor,
                  cfg: StftConfig,
                  beamformer: str = "mvdr",
                  ban: bool = False,
                  steer: str = "power",
                  power_iters: int = 15,
                  nsamps: int | None = None) -> torch.Tensor:
    """(B, N, S) wav + (B, T, F) speech mask -> (B, S) enhanced wav.

    ``wav`` may be int16: the kernels convert it with 1/32768 folded
    into the analysis window.  The output matches running on
    ``wav.float() / 32768``.  ``steer`` is read only for mvdr, as in the
    JAX package.
    """
    check_fused_options(beamformer, steer)
    return _run(wav, mask_s, cfg, beamformer, ban, power_iters, nsamps,
                _KERNELS)


def enhance_plain(wav: torch.Tensor,
                  mask_s: torch.Tensor,
                  cfg: StftConfig,
                  beamformer: str = "mvdr",
                  ban: bool = False,
                  power_iters: int = 15,
                  nsamps: int | None = None) -> torch.Tensor:
    """``enhance_fused`` through the kernels' plain versions, on the
    tensors' own device: the reference the kernels are held against."""
    check_fused_options(beamformer, "power")
    full_f32_matmuls(wav.device)
    return _run(wav, mask_s, cfg, beamformer, ban, power_iters, nsamps,
                _PLAIN)


def _run_online(wav, mask_s, cfg, chunk_size, alpha, power_iters, nsamps,
                ops: _Ops):
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    _, window, wss_inv, mask = _prepare(wav, mask_s, cfg, nsamps)
    part = ops.stft_covar_chunks(wav, mask, window, chunk_size)
    es, en = ops.covar_ema(part, mask, chunk_size, alpha)  # (B, C, F, N, N)
    w = ops.mvdr_power(es, en, power_iters=power_iters)    # (B, C, F, N)
    return ops.beamform_istft_online(wav, w, wss_inv, window, chunk_size)


def mvdr_enhance_fused_online(wav: torch.Tensor,
                              mask_s: torch.Tensor,
                              cfg: StftConfig,
                              chunk_size: int,
                              alpha: float = 0.8,
                              power_iters: int = 15,
                              nsamps: int | None = None) -> torch.Tensor:
    """Online (chunked EMA) MVDR: (B, N, S) wav + (B, T, F) mask ->
    (B, S) enhanced wav.

    Semantics of ``beamformer.online_supervised_run`` with the power
    steer (the reference's --update-periods streaming): chunk c covers
    frames [c chunk, min(T, (c+1) chunk)); its masked covariances,
    normalized by the chunk's own mask sums, blend as
    R <- alpha R + (1 - alpha) R_c (the first chunk initializes); each
    chunk is beamformed with the MVDR weights of the state after it.
    """
    return _run_online(wav, mask_s, cfg, chunk_size, alpha, power_iters,
                       nsamps, _KERNELS)


def enhance_plain_online(wav: torch.Tensor,
                         mask_s: torch.Tensor,
                         cfg: StftConfig,
                         chunk_size: int,
                         alpha: float = 0.8,
                         power_iters: int = 15,
                         nsamps: int | None = None) -> torch.Tensor:
    """``mvdr_enhance_fused_online`` through the kernels' plain versions,
    on the tensors' own device."""
    full_f32_matmuls(wav.device)
    return _run_online(wav, mask_s, cfg, chunk_size, alpha, power_iters,
                       nsamps, _PLAIN)


def planar_supported(cfg: StftConfig, num_mics: int,
                     nsamps: int | None = None) -> bool:
    """The port's gate for the planar kernels: n_fft == 2 hop, n_fft a
    power of two in [256, 2048], 1 <= N <= 8 and, when given, S >= n_fft
    (the JAX gate's n_fft % 256 == 0 admits 768 and the like; on the card
    those take the spectrum-domain run)."""
    return (cfg.n_fft in pl.PLANAR_NFFT and cfg.n_fft == 2 * cfg.frame_hop
            and 1 <= num_mics <= cp.MAX_MICS
            and (nsamps is None or nsamps >= cfg.n_fft))


def _run_planar(wav, mask_s, cfg, power_iters, nsamps, ops: _Ops):
    b, n, s = wav.shape
    if not planar_supported(cfg, n, s):
        raise ValueError(f"wav {tuple(wav.shape)} with {cfg} is outside the "
                         f"planar kernels' gate")
    full_f32_matmuls(wav.device)
    t = cfg.num_frames(s)
    fh = cfg.n_fft // 2        # bins 0 .. fh-1 in the planes; fh = Nyquist
    out_samps = nsamps if nsamps is not None else s
    window, wss_inv = _constants(cfg, t, out_samps, wav.device)
    mask = mask_s.to(torch.float32).contiguous()          # (B, T, F)
    re, im, nyq = ops.stft_planar(wav, window, cfg.center)  # (B, N, T, FH)
    rs_re, rs_im, rn_re, rn_im = ops.pair_covar_complement(
        re, im, mask[..., :fh], n_valid_t=t)
    den_s = mask.sum(dim=1)                               # (B, F)
    den_n = t - den_s                  # sum of (1 - m) over the T frames

    def covar(num_re, num_im, den):
        num = torch.complex(num_re, num_im).permute(0, 3, 1, 2)
        return num / torch.clamp(den[:, :fh], min=1e-6)[..., None, None]

    # the Nyquist bin is real: its covariances are plain tensor code
    m_ny = mask[..., fh]                                  # (B, T)
    rs_ny = torch.einsum("bt,bxt,byt->bxy", m_ny, nyq, nyq) / torch.clamp(
        den_s[:, fh], min=1e-6)[:, None, None]
    rn_ny = torch.einsum("bt,bxt,byt->bxy", torch.clamp(1.0 - m_ny, min=0.0),
                         nyq, nyq) / torch.clamp(den_n[:, fh],
                                                 min=1e-6)[:, None, None]
    rs = torch.cat([covar(rs_re, rs_im, den_s),
                    rs_ny[:, None].to(torch.complex64)], dim=1)
    rn = torch.cat([covar(rn_re, rn_im, den_n),
                    rn_ny[:, None].to(torch.complex64)], dim=1)
    w = ops.mvdr_power(rs.contiguous(), rn.contiguous(),
                       power_iters=power_iters)           # (B, F, N)
    # planar beamform: enh[b,t,f] = sum_n conj(w[b,f,n]) obs[b,n,t,f]
    wr = w[:, :fh].real.transpose(1, 2)[:, :, None, :]    # (B, N, 1, FH)
    wi = w[:, :fh].imag.transpose(1, 2)[:, :, None, :]
    enh_re = (wr * re + wi * im).sum(1)                   # (B, T, FH)
    enh_im = (wr * im - wi * re).sum(1)
    w_ny = w[:, fh]                                       # (B, N)
    ny_re = (w_ny.real[:, :, None] * nyq).sum(1)          # (B, T)
    if cfg.center:
        return ops.istft_planar(enh_re.contiguous(), enh_im.contiguous(),
                                ny_re.contiguous(), window, wss_inv,
                                out_samps)
    ny_im = (-w_ny.imag[:, :, None] * nyq).sum(1)
    enh = torch.complex(torch.cat([enh_re, ny_re[..., None]], dim=-1),
                        torch.cat([enh_im, ny_im[..., None]], dim=-1))
    return inverse_stft(enh, cfg, nsamps=out_samps)


def mvdr_enhance_planar(wav: torch.Tensor,
                        mask_s: torch.Tensor,
                        cfg: StftConfig,
                        power_iters: int = 15,
                        nsamps: int | None = None) -> torch.Tensor:
    """MVDR (power steer) through the planar kernels: (B, N, S) wav +
    (B, T, F) speech mask -> (B, S') enhanced wav, S' = ``nsamps`` or S.

    ``wav`` may be int16: the STFT kernel converts it with 1/32768 folded
    into the window, and the output matches running on
    ``wav.float() / 32768``.
    """
    return _run_planar(wav, mask_s, cfg, power_iters, nsamps, _KERNELS)


def mvdr_enhance_planar_plain(wav: torch.Tensor,
                              mask_s: torch.Tensor,
                              cfg: StftConfig,
                              power_iters: int = 15,
                              nsamps: int | None = None) -> torch.Tensor:
    """``mvdr_enhance_planar`` through the kernels' plain versions, on the
    tensors' own device: the reference the kernels are held against."""
    return _run_planar(wav, mask_s, cfg, power_iters, nsamps, _PLAIN)
