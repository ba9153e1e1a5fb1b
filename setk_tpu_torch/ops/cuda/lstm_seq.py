"""The bidirectional LSTM recurrence, forward and BPTT (kernels 20, 21).

Counterpart of ``setk_tpu/ops/pallas/lstm_seq.py``; kernel source
``setk_tpu_torch/csrc/lstm_seq.cu``:

  lstm_seq_forward (kernel 20; ``_forward`` :130): xg_f, xg_b (T, B, 4H)
      f32 gate pre-activations (i | f | g | o, both in natural time order),
      W_h (H, 4H) f32 or bf16 -> ys_f, cs_f, ys_b, cs_b (T, B, H) f32, the
      hidden and cell states in natural time order (ys_b[t] is the backward
      direction's state after consuming frames T-1 .. t);
  lstm_seq_backward (kernel 21; ``_backward`` :159): dxg_f, dxg_b (T, B,
      4H) f32 from the output gradients, the gates and the saved hidden and
      cell states; each direction's processing-order previous state is the
      saved state at the neighbouring frame (zero at its first frame), read
      in place of the JAX package's shifted copies (:212-220).

h is rounded to W_h's type before each recurrent product, and the
backward pass rounds dgates the same way before the W_h^T product, as the
TPU kernels do; sums are f32.  ``lstm_seq_bidir`` is the differentiable
pair (the JAX package's ``custom_vjp``, :197-236): dW_h = h_prev^T dxg over
T B is one matrix product outside kernel 21.  The ``*_plain`` functions
are the plain PyTorch versions (a loop over T; ``lstm_cell`` and
``round_to`` are the cell and the rounding that ``models.mask_net``'s
scan runs too).  ``lstm_seq_supported`` is the port's gate: any B >= 1
and 1 <= H <= 1024 (one thread a hidden unit), not the TPU's B % 8 == 0
and H % 128 == 0.

Kernels 20 and 21 each have two variants with one contract, each with
its own entry point and launch count: ``lstm_seq_forward_resident`` and
``lstm_seq_backward_resident`` (a cooperative grid of one block an SM,
W_h sliced across the blocks and held in shared memory, one grid barrier
a step; kernel 21's recomputes the gates of every frame first, off the
serial chain, and exchanges the rounded dgates between steps through a
ping-pong buffer) and ``lstm_seq_forward_stream`` and
``lstm_seq_backward_stream`` (the first design: a block a tile of 4 batch
rows streams W_h from L2 every step).  ``lstm_seq_forward`` and
``lstm_seq_backward`` take the one that ``forward_variant`` and
``backward_variant`` pick from B, H, the weight type and the device's SM
count and opt-in shared memory (``device_limits``): the resident one
wherever its layout fits (on an H100 every bf16 H <= 1024 at B = 64, so
every ``MaskNet`` call; f32 up to H = 891 forward and H = 792 backward),
the stream one elsewhere.  A failed launch raises; nothing falls back.
"""

import ctypes
import functools

import torch

from setk_tpu_torch.ops.cuda import _build

__all__ = ["MAX_HIDDEN", "lstm_seq_supported", "lstm_seq_bidir",
           "lstm_seq_forward", "lstm_seq_forward_resident",
           "lstm_seq_forward_stream", "lstm_seq_forward_plain",
           "lstm_seq_backward", "lstm_seq_backward_resident",
           "lstm_seq_backward_stream", "lstm_seq_backward_plain",
           "lstm_cell", "round_to", "resident_layout", "forward_variant",
           "backward_resident_layout", "backward_variant", "device_limits"]

MAX_HIDDEN = 1024
# the resident variants' block, a thread's rows and kernel 21's least
# dgates columns a chunk (csrc/lstm_seq.cu kResThreads, kResRows, kMinChunk)
RESIDENT_THREADS = 256
RESIDENT_ROWS = 8
RESIDENT_MIN_CHUNK = 64


def lstm_seq_supported(batch: int, hidden: int) -> bool:
    return batch >= 1 and 1 <= hidden <= MAX_HIDDEN


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _odd_stride(n: int) -> int:
    """A tile's row stride for n values (csrc/lstm_seq.cu odd_stride)."""
    stride = -(-n // 4) * 4
    return stride + 4 if (stride // 4) % 2 == 0 else stride


def resident_layout(batch: int, hidden: int, weight_bytes: int, sms: int,
                    smem: int):
    """The resident variant's layout on a device with ``sms`` SMs and
    ``smem`` bytes of shared memory a block: (blocks a direction, units a
    block, h-tile row stride in floats, h-tile rows, dynamic shared memory
    in bytes), or None where it does not fit.  csrc/lstm_seq.cu
    ``resident_layout`` is the same arithmetic: a thread holds one unit's
    four gate sums for 8 rows, and the k shares' partial sums reuse the h
    tile's space."""
    per_dir = sms // 2
    if per_dir < 1:
        return None
    units = -(-hidden // per_dir)
    if units > RESIDENT_THREADS:
        return None
    w_bytes = _round16(hidden * 4 * units * weight_bytes)
    stride = _odd_stride(hidden)
    red_bytes = 4 * RESIDENT_THREADS * RESIDENT_ROWS * 4
    if w_bytes + red_bytes > smem:
        return None
    rows = min(batch, (smem - w_bytes) // (4 * stride),
               RESIDENT_ROWS * (RESIDENT_THREADS // units))
    if rows < 1:
        return None
    return (per_dir, units, stride, rows,
            w_bytes + max(rows * 4 * stride, red_bytes))


def forward_variant(batch: int, hidden: int, dtype: torch.dtype, sms: int,
                    smem: int) -> str:
    """Kernel 20's variant for (B, H, W_h's type) on a device with ``sms``
    SMs and ``smem`` bytes of opt-in shared memory a block: "resident"
    where its layout fits, else "stream"."""
    return ("resident" if resident_layout(batch, hidden, dtype.itemsize,
                                          sms, smem) else "stream")


def backward_resident_layout(batch: int, hidden: int, weight_bytes: int,
                             sms: int, smem: int):
    """Kernel 21's resident layout on a device with ``sms`` SMs and ``smem``
    bytes of shared memory a block: (blocks a direction, units a block,
    phase-1 h-tile rows over the flattened (t, b) index, its stride in
    floats, phase-2 dgates-tile batch rows, the dgates columns of a chunk
    (a multiple of 8), its stride in floats, dynamic shared memory in
    bytes), or None
    where it does not fit.  csrc/lstm_seq.cu ``bwd_resident_layout`` is the
    same arithmetic (``lstm_bwd_layout`` returns it): the larger of the
    column and the row slice of W_h (the row slice in groups of 4 units),
    the dc carry (B x u f32), then a tile space that the partial sums
    reuse."""
    per_dir = sms // 2
    if per_dir < 1:
        return None
    units = -(-hidden // per_dir)
    if units > RESIDENT_THREADS:
        return None
    groups = -(-units // 4)
    w_bytes = _round16(max(hidden * 4 * units, 16 * hidden * groups) *
                       weight_bytes)
    dc_bytes = _round16(4 * batch * units)
    red_bytes = 4 * RESIDENT_THREADS * RESIDENT_ROWS * 4
    if w_bytes + dc_bytes + red_bytes > smem:
        return None
    budget = smem - w_bytes - dc_bytes
    stride1 = _odd_stride(hidden)
    lim1 = min(budget // (4 * stride1),
               RESIDENT_ROWS * (RESIDENT_THREADS // units))
    # 8 rows a row group and a power of 2 of row groups
    rows1 = (lim1 if lim1 < RESIDENT_ROWS else RESIDENT_ROWS *
             (1 << ((lim1 // RESIDENT_ROWS).bit_length() - 1)))
    rows2 = min(batch, RESIDENT_ROWS * (RESIDENT_THREADS // groups),
                budget // (4 * (RESIDENT_MIN_CHUNK + 8)))
    if rows1 < 1 or rows2 < 1:
        return None
    chunk_max = budget // (4 * rows2) // 8 * 8 - 8
    chunks = -(-4 * hidden // chunk_max)
    chunk = -(-(-(-4 * hidden // chunks)) // 8) * 8
    stride2 = _odd_stride(chunk)
    return (per_dir, units, rows1, stride1, rows2, chunk, stride2,
            w_bytes + dc_bytes + max(red_bytes, 4 * rows1 * stride1,
                                     4 * rows2 * stride2))


def backward_variant(batch: int, hidden: int, dtype: torch.dtype, sms: int,
                     smem: int) -> str:
    """Kernel 21's variant for (B, H, W_h's type) on a device with ``sms``
    SMs and ``smem`` bytes of opt-in shared memory a block: "resident"
    where its layout fits, else "stream"."""
    return ("resident" if backward_resident_layout(
        batch, hidden, dtype.itemsize, sms, smem) else "stream")


def device_limits(device) -> tuple:
    """(SM count, opt-in shared memory a block in bytes) of the CUDA
    ``device``, as the kernel library reads them; once per device."""
    index = torch.device(device).index
    return _limits(torch.cuda.current_device() if index is None else index)


@functools.cache
def _limits(index: int) -> tuple:
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        _build.check(_build.library("lstm_seq").lstm_device_limits(
            ctypes.addressof(out)), "lstm_device_limits")
    return out[0], out[1]


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (f32) rounded to ``dtype`` and widened back (bf16: nearest even)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _split(gates: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    """One LSTM step from the gate pre-activations (i | f | g | o): the
    new (h, c)."""
    i, f, g, o = _split(gates)
    c = f * c + i * g
    return o * torch.tanh(c), c


def _forward_dir(xg, wh, reverse):
    w = wh.float()
    t_len, b, h4 = xg.shape
    h = xg.new_zeros((b, h4 // 4))
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        h, c = lstm_cell(xg[t] + round_to(h, wh.dtype) @ w, c)
        hs.append(h)
        cs.append(c)
    if reverse:
        hs.reverse()
        cs.reverse()
    return torch.stack(hs), torch.stack(cs)


def lstm_seq_forward_plain(xgf, xgb, whf, whb):
    """Plain version of kernel 20 (differentiable)."""
    ysf, csf = _forward_dir(xgf, whf, False)
    ysb, csb = _forward_dir(xgb, whb, True)
    return ysf, csf, ysb, csb


def _backward_dir(dy, xg, hs, cs, wh, ascending):
    """``ascending``: the backward direction, whose previous state in
    processing order is the frame after t."""
    w = wh.float()
    t_len, b, h4 = xg.shape
    dh = xg.new_zeros((b, h4 // 4))
    dc = torch.zeros_like(dh)
    dx = torch.empty_like(xg)
    for t in (range(t_len) if ascending else range(t_len - 1, -1, -1)):
        tp = t + 1 if ascending else t - 1
        if 0 <= tp < t_len:
            hp, cp = hs[tp], cs[tp]
        else:
            hp = cp = torch.zeros_like(dh)
        i, f, g, o = _split(xg[t] + round_to(hp, wh.dtype) @ w)
        tc = torch.tanh(cs[t])
        dhh = dy[t] + dh
        d_o = dhh * tc * o * (1 - o)
        dcc = dc + dhh * o * (1 - tc * tc)
        d_i = dcc * g * i * (1 - i)
        d_g = dcc * i * (1 - g * g)
        d_f = dcc * cp * f * (1 - f)
        dc = dcc * f
        dx[t] = torch.cat([d_i, d_f, d_g, d_o], dim=-1)
        dh = round_to(dx[t], wh.dtype) @ w.t()
    return dx


def lstm_seq_backward_plain(dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf,
                            whb):
    """Plain version of kernel 21: each direction in the reverse of its
    processing order (the forward direction descending in t)."""
    return (_backward_dir(dyf, xgf, ysf, csf, whf, False),
            _backward_dir(dyb, xgb, ysb, csb, whb, True))


def _check(what, seqs, gates, whf, whb):
    t_len, b, h4 = gates[0].shape
    h = h4 // 4
    dev = gates[0].device
    for x, shape in [(g, (t_len, b, h4)) for g in gates] + \
            [(s, (t_len, b, h)) for s in seqs]:
        if x.dtype != torch.float32 or tuple(x.shape) != shape or \
                not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{what}: needs contiguous float32 {shape} "
                             f"tensors on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if h4 % 4 or t_len < 1 or not lstm_seq_supported(b, h):
        raise ValueError(f"{what}: needs T >= 1, B >= 1 and 1 <= H <= "
                         f"{MAX_HIDDEN}, got (T, B, 4H) = {(t_len, b, h4)}")
    for w in (whf, whb):
        if w.dtype not in (torch.float32, torch.bfloat16) or \
                w.dtype != whf.dtype or tuple(w.shape) != (h, h4) or \
                not w.is_contiguous() or w.device != dev:
            raise ValueError(f"{what}: W_h must be two contiguous float32 "
                             f"or bfloat16 {(h, h4)} tensors of one type on "
                             f"{dev}, got {w.dtype} {tuple(w.shape)}")
    return t_len, b, h


def _forward_launch(what, entry, xgf, xgb, whf, whb):
    t_len, b, h = _check(what, (), (xgf, xgb), whf, whb)
    out = [torch.empty((t_len, b, h), dtype=torch.float32, device=xgf.device)
           for _ in range(4)]
    _build.launch("lstm_seq", entry, xgf.device, xgf.data_ptr(),
                  xgb.data_ptr(), whf.data_ptr(), whb.data_ptr(),
                  *(o.data_ptr() for o in out), t_len, b, h,
                  int(whf.dtype == torch.bfloat16))
    return tuple(out)


def lstm_seq_forward_resident(xgf, xgb, whf, whb):
    """Kernel 20's resident variant (see ``lstm_seq_forward``); raises
    where its layout does not fit the device or the grid cannot be
    co-resident.  ``lstm_seq_forward_resident.launches`` counts its
    launches."""
    if xgf.device.type == "cpu":
        return lstm_seq_forward_plain(xgf, xgb, whf, whb)
    out = _forward_launch("lstm_seq_forward_resident",
                          "lstm_fwd_resident_launch", xgf, xgb, whf, whb)
    lstm_seq_forward_resident.launches += 1
    return out


def lstm_seq_forward_stream(xgf, xgb, whf, whb):
    """Kernel 20's stream variant (see ``lstm_seq_forward``);
    ``lstm_seq_forward_stream.launches`` counts its launches."""
    if xgf.device.type == "cpu":
        return lstm_seq_forward_plain(xgf, xgb, whf, whb)
    out = _forward_launch("lstm_seq_forward_stream",
                          "lstm_fwd_stream_launch", xgf, xgb, whf, whb)
    lstm_seq_forward_stream.launches += 1
    return out


def lstm_seq_forward(xgf, xgb, whf, whb):
    """Kernel 20: (ys_f, cs_f, ys_b, cs_b), each (T, B, H) f32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    variant that ``forward_variant`` picks (``lstm_seq_forward.launches``
    counts the launches of both, each variant's wrapper its own).
    """
    if xgf.device.type == "cpu":
        return lstm_seq_forward_plain(xgf, xgb, whf, whb)
    _, b, h = _check("lstm_seq_forward", (), (xgf, xgb), whf, whb)
    variant = forward_variant(b, h, whf.dtype, *device_limits(xgf.device))
    run = (lstm_seq_forward_resident if variant == "resident" else
           lstm_seq_forward_stream)
    out = run(xgf, xgb, whf, whb)
    lstm_seq_forward.launches += 1
    return out


def _backward_launch(what, entry, args, scratch):
    """Kernel 21 through C entry ``entry``: the ten inputs, the two
    tensors ``scratch(B, H)`` gives, then dxg_f and dxg_b, which it
    returns."""
    dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf, whb = args
    t_len, b, h = _check(what, (dyf, dyb, ysf, ysb, csf, csb), (xgf, xgb),
                         whf, whb)
    dx = (torch.empty_like(xgf), torch.empty_like(xgb))
    _build.launch("lstm_seq", entry, xgf.device,
                  *(x.data_ptr() for x in (*args, *scratch(b, h), *dx)),
                  t_len, b, h, int(whf.dtype == torch.bfloat16))
    return dx


def lstm_seq_backward_resident(dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf,
                               whb):
    """Kernel 21's resident variant (see ``lstm_seq_backward``); raises
    where its layout does not fit the device or the grid cannot be
    co-resident.  ``lstm_seq_backward_resident.launches`` counts its
    launches."""
    args = (dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf, whb)
    if xgf.device.type == "cpu":
        return lstm_seq_backward_plain(*args)
    # the rounded dgates' ping-pong exchange of each direction
    out = _backward_launch(
        "lstm_seq_backward_resident", "lstm_bwd_resident_launch", args,
        lambda b, h: [torch.empty((2, b, 4 * h), dtype=whf.dtype,
                                  device=xgf.device) for _ in "fb"])
    lstm_seq_backward_resident.launches += 1
    return out


def lstm_seq_backward_stream(dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf,
                             whb):
    """Kernel 21's stream variant (see ``lstm_seq_backward``);
    ``lstm_seq_backward_stream.launches`` counts its launches."""
    args = (dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf, whb)
    if xgf.device.type == "cpu":
        return lstm_seq_backward_plain(*args)
    out = _backward_launch(
        "lstm_seq_backward_stream", "lstm_bwd_stream_launch", args,
        lambda b, h: (whf.t().contiguous(), whb.t().contiguous()))
    lstm_seq_backward_stream.launches += 1
    return out


def lstm_seq_backward(dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf, whb):
    """Kernel 21: (dxg_f, dxg_b), each (T, B, 4H) f32, from the output
    gradients, the gates and kernel 20's states.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    variant that ``backward_variant`` picks (``lstm_seq_backward.launches``
    counts the launches of both, each variant's wrapper its own).
    """
    args = (dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf, whb)
    if xgf.device.type == "cpu":
        return lstm_seq_backward_plain(*args)
    _, b, h = _check("lstm_seq_backward", (dyf, dyb, ysf, ysb, csf, csb),
                     (xgf, xgb), whf, whb)
    variant = backward_variant(b, h, whf.dtype, *device_limits(xgf.device))
    run = (lstm_seq_backward_resident if variant == "resident" else
           lstm_seq_backward_stream)
    out = run(*args)
    lstm_seq_backward.launches += 1
    return out


class _Bidir(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xgf, xgb, whf, whb):
        ysf, csf, ysb, csb = lstm_seq_forward(xgf, xgb, whf, whb)
        ctx.save_for_backward(xgf, xgb, whf, whb, ysf, ysb, csf, csb)
        return ysf, ysb

    @staticmethod
    def backward(ctx, dyf, dyb):
        xgf, xgb, whf, whb, ysf, ysb, csf, csb = ctx.saved_tensors
        dxf, dxb = lstm_seq_backward(dyf.contiguous(), dyb.contiguous(), xgf,
                                     xgb, ysf, ysb, csf, csb, whf, whb)
        h = ysf.shape[-1]

        def dwh(hp, dx, w):
            # h_prev^T dxg over the frames that have a previous state (the
            # first frame's is zero), on views of the saved states
            return (hp.reshape(-1, h).t() @ dx.reshape(-1, 4 * h)).to(
                w.dtype)

        return (dxf, dxb, dwh(ysf[:-1], dxf[1:], whf),
                dwh(ysb[1:], dxb[:-1], whb))


def lstm_seq_bidir(xgf, xgb, whf, whb):
    """Bidirectional LSTM over pre-projected gates: (ys_f, ys_b), each
    (T, B, H) f32 in natural time order, differentiable through kernels 20
    and 21 (their plain versions on CPU tensors).  W_h's gradient comes
    back in W_h's type, as ``.astype(whf.dtype)`` does (:232-233)."""
    return _Bidir.apply(xgf, xgb, whf, whb)


lstm_seq_forward.launches = 0
lstm_seq_forward_resident.launches = 0
lstm_seq_forward_stream.launches = 0
lstm_seq_backward.launches = 0
lstm_seq_backward_resident.launches = 0
lstm_seq_backward_stream.launches = 0
