"""Neural T-F mask estimators (DNN / TDNN / CNN-TDNN / LSTM / BLSTM).

Counterpart of ``setk_tpu/models/mask_net.py`` as ``torch.nn`` modules:
input is the log-magnitude spectrogram (B, T, F), output a sigmoid mask
(B, T, F); the objective is the frame-masked quadratic loss.  Submodules
carry the flax module's automatic names (``LayerNorm_0``, ``Dense_3``,
``FastLSTM_1``, ``TdnnBlock_0.Dense_0``, ``Conv_2``), so a state dict maps
to the flax parameter tree name by name (``convert.mask_net_params_*``).
Layouts and defaults follow flax: a Dense weight is kept (out, in) as
``nn.Linear``'s and transposed by the converter, LayerNorm uses
epsilon 1e-6 and flax's E[x^2] - E[x]^2 variance, a Conv pads as
``padding="SAME"`` (asymmetric where the frequency stride is 2 and F is
even), the recurrent weights are initialised orthogonal.

The recurrent product is bf16 with f32 sums, as ``_rec_matmul`` (:61)
rounds it: h and W_h are rounded, the projections and the activations
between layers stay f32 (the TPU dispatch's bf16 projections are for its
matrix unit's speed; ROADMAP queue 3).  On a CUDA tensor inside the gate
(``lstm_seq_supported``) a bidirectional ``FastLSTM`` runs the whole
sequence through kernels 20/21 (``ops.cuda.lstm_seq.lstm_seq_bidir``);
outside the gate (H > 1024) it refuses on the card, naming ROADMAP queue 1
item 16, and never falls back to the loop there.  On a CPU tensor, and
for the unidirectional ``lstm`` arch (a ``lax.scan`` in the JAX package,
no kernel), it is a PyTorch loop over T over ``lstm_seq``'s own cell.
"""

import math

import torch
from torch import nn

from setk_tpu_torch.ops.cuda import lstm_seq as ls

__all__ = ["MaskNet", "make_model", "quadratic_loss", "refuse_on_card",
           "ARCHS"]

ARCHS = ("dnn", "tdnn", "cnn-tdnn", "lstm", "blstm")
LN_EPS = 1e-6     # flax LayerNorm's default epsilon


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def refuse_on_card(arch: str, hidden: int, device) -> None:
    """Raise ``NotImplementedError`` where a MaskNet of ``arch`` and
    ``hidden`` would need kernels 20/21 outside their gate on ``device``:
    a blstm wider than 1024 hidden units on a CUDA device."""
    if torch.device(device).type == "cuda" and arch == "blstm" and \
            not ls.lstm_seq_supported(1, hidden):
        raise NotImplementedError(
            f"a blstm with hidden = {hidden} on a CUDA device needs kernels "
            f"20/21 beyond H <= {ls.MAX_HIDDEN}, which arrives with ROADMAP "
            f"queue 1 item 16")


def _shifted_frames(x, offsets):
    """Edge-clamped time-shifted copies of (..., T, F): one edge pad, then
    slices."""
    t = x.shape[-2]
    left = max(-min(offsets), 0)
    right = max(max(offsets), 0)
    xp = torch.cat([x[..., :1, :].expand(*x.shape[:-2], left, x.shape[-1]),
                    x,
                    x[..., -1:, :].expand(*x.shape[:-2], right,
                                          x.shape[-1])], dim=-2)
    return [xp[..., off + left:off + left + t, :] for off in offsets]


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    """flax's default kernel init: a normal truncated at +-2 std with
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal weight, zero bias."""

    def reset_parameters(self, gen=None):
        _lecun_normal_(self.weight, self.in_features, gen)
        nn.init.zeros_(self.bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, gen=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + \
            self.bias


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), strides, padding="SAME")`` over a
    (B, T, F, C) input, the weight kept (out, in, kh, kw)."""

    def __init__(self, c_in: int, c_out: int, strides=(1, 1)):
        super().__init__()
        self.strides = tuple(strides)
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        _lecun_normal_(self.weight, 9 * self.weight.shape[1], gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        pads = []
        for size, stride in zip(x.shape[1:3], self.strides):
            total = max((-(-size // stride) - 1) * stride + 3 - size, 0)
            pads.append((total // 2, total - total // 2))
        h = x.permute(0, 3, 1, 2)
        h = nn.functional.pad(h, pads[1] + pads[0])
        h = nn.functional.conv2d(h, self.weight, self.bias, self.strides)
        return h.permute(0, 2, 3, 1)


def _rec_matmul(h, wh):
    """Recurrent h @ W_h in bf16 with f32 sums (h and W_h rounded)."""
    return ls.round_to(h, torch.bfloat16) @ ls.round_to(wh, torch.bfloat16)


class FastLSTM(nn.Module):
    """LSTM layer (uni- or bidirectional) over time-major (T, B, F) input,
    as MaskNet runs it, with time-parallel input projections ``wx_f`` /
    ``wx_b`` (biases included) and recurrent weights ``wh_f`` / ``wh_b``
    (H, 4H), gates ordered i | f | g | o."""

    def __init__(self, d_in: int, hidden: int, bidirectional: bool = False):
        super().__init__()
        self.hidden = hidden
        self.bidirectional = bidirectional
        h4 = 4 * hidden
        self.wx_f = Dense(d_in, h4)
        self.wh_f = nn.Parameter(torch.empty(hidden, h4))
        if bidirectional:
            self.wx_b = Dense(d_in, h4)
            self.wh_b = nn.Parameter(torch.empty(hidden, h4))
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        """The recurrent weights; the projections draw their own."""
        for name in ("f", "b") if self.bidirectional else ("f",):
            nn.init.orthogonal_(getattr(self, f"wh_{name}"), generator=gen)

    def forward(self, x):
        if self.bidirectional and _on_card(x):
            refuse_on_card("blstm", self.hidden, "cuda")
        xg_f = self.wx_f(x).contiguous()
        if not self.bidirectional:
            ys = self._scan(xg_f, self.wh_f)
        elif _on_card(x):
            ys_f, ys_b = ls.lstm_seq_bidir(
                xg_f, self.wx_b(x).contiguous(),
                self.wh_f.to(torch.bfloat16), self.wh_b.to(torch.bfloat16))
            ys = torch.cat([ys_f, ys_b], dim=-1)
        else:
            xg_b = self.wx_b(x)
            ys = torch.cat([self._scan(xg_f, self.wh_f),
                            self._scan(xg_b.flip(0), self.wh_b).flip(0)],
                           dim=-1)
        return ys

    def _scan(self, xg, wh):
        """The JAX package's scan: W_h is cast from the f32 parameter in
        every step, so each step's share of dW_h is rounded to bf16 and
        the shares add up in f32 (kernel 20's plain version casts once)."""
        h = xg.new_zeros((xg.shape[1], self.hidden))
        c = torch.zeros_like(h)
        ys = []
        for xg_t in xg:
            h, c = ls.lstm_cell(xg_t + _rec_matmul(h, wh), c)
            ys.append(h)
        return torch.stack(ys)


class TdnnBlock(nn.Module):
    """Time-dilated affine over frames (t - d, t, t + d), LayerNorm, ReLU."""

    def __init__(self, d_in: int, dim: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.Dense_0 = Dense(3 * d_in, dim)
        self.LayerNorm_0 = LayerNorm(dim)

    def forward(self, x):
        d = self.dilation
        x = torch.cat(_shifted_frames(x, (-d, 0, d)), dim=-1)
        return torch.relu(self.LayerNorm_0(self.Dense_0(x)))


class MaskNet(nn.Module):
    """Sigmoid T-F mask estimator over log-magnitude inputs (B, T, F)."""

    # the cnn-tdnn front-end: (filters, frequency stride) of each conv
    CONVS = ((32, 1), (32, 1), (64, 2), (32, 1))
    CONTEXT = 2        # the dnn's spliced frames on either side

    def __init__(self, arch: str = "dnn", num_bins: int = 257,
                 hidden: int = 512, num_layers: int = 3):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"Unknown arch: {arch}")
        self.arch, self.num_bins = arch, num_bins
        self.hidden, self.num_layers = hidden, num_layers
        self.LayerNorm_0 = LayerNorm(num_bins)
        if arch == "dnn":
            d = num_bins * (2 * self.CONTEXT + 1)
            for i in range(num_layers):
                self.add_module(f"Dense_{i}", Dense(d, hidden))
                self.add_module(f"LayerNorm_{i + 1}", LayerNorm(hidden))
                d = hidden
            out = f"Dense_{num_layers}"
        elif arch in ("tdnn", "cnn-tdnn"):
            if arch == "tdnn":
                self.Dense_0 = Dense(num_bins, hidden)
                d, out = hidden, "Dense_1"
            else:
                c, f = 1, num_bins
                for i, (filters, stride) in enumerate(self.CONVS):
                    self.add_module(f"Conv_{i}", Conv(c, filters,
                                                      (1, stride)))
                    self.add_module(f"LayerNorm_{i + 1}", LayerNorm(filters))
                    c, f = filters, -(-f // stride)
                d, out = c * f, "Dense_0"
            for i in range(num_layers):
                self.add_module(f"TdnnBlock_{i}",
                                TdnnBlock(d, hidden, dilation=2**i))
                d = hidden
        else:
            bidir = arch == "blstm"
            d = num_bins
            for i in range(num_layers):
                self.add_module(f"FastLSTM_{i}", FastLSTM(
                    d, hidden, bidirectional=bidir))
                d = 2 * hidden if bidir else hidden
            out = "Dense_0"
        self.add_module(out, Dense(d, num_bins))
        self._out = out

    def reset_parameters(self, gen=None):
        """Draw every parameter as flax's initializers do, from ``gen``."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)

    def forward(self, x):
        x = self.LayerNorm_0(x)
        sub = self._modules
        if self.arch == "dnn":
            x = torch.cat(_shifted_frames(
                x, range(-self.CONTEXT, self.CONTEXT + 1)), dim=-1)
            for i in range(self.num_layers):
                x = torch.relu(sub[f"LayerNorm_{i + 1}"](sub[f"Dense_{i}"](x)))
        elif self.arch in ("tdnn", "cnn-tdnn"):
            if self.arch == "tdnn":
                x = torch.relu(self.Dense_0(x))
            else:
                h = x[..., None]                        # (B, T, F, 1)
                for i in range(len(self.CONVS)):
                    h = torch.relu(sub[f"LayerNorm_{i + 1}"](
                        sub[f"Conv_{i}"](h)))
                x = h.reshape(h.shape[:-2] + (h.shape[-2] * h.shape[-1],))
            for i in range(self.num_layers):
                x = sub[f"TdnnBlock_{i}"](x)
        else:
            x = x.transpose(0, 1)                       # (T, B, F)
            for i in range(self.num_layers):
                x = sub[f"FastLSTM_{i}"](x)
            x = x.transpose(0, 1)
        return torch.sigmoid(sub[self._out](x))


def make_model(arch: str = "dnn", num_bins: int = 257, hidden: int = 512,
               num_layers: int = 3) -> MaskNet:
    return MaskNet(arch=arch, num_bins=num_bins, hidden=hidden,
                   num_layers=num_layers)


def quadratic_loss(pred, target, frame_mask=None):
    """Mean squared error, ignoring padded frames.

    pred/target: (B, T, F); frame_mask: (B, T) 1 for valid frames.
    """
    err = (pred - target)**2
    if frame_mask is None:
        return err.mean()
    weights = frame_mask[..., None]
    return (err * weights).sum() / torch.clamp(
        weights.sum() * pred.shape[-1], min=1.0)
