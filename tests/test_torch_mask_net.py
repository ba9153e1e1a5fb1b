"""The port's neural mask estimators against setk_tpu's, on the CPU.

- Kernels 20 and 21's plain versions (``lstm_seq_forward_plain``,
  ``lstm_seq_backward_plain``, through ``lstm_seq_bidir``'s autograd)
  against the JAX ``lstm_seq_bidir`` in interpret mode at T=12, B=8,
  H=128 (tests/test_pallas_lstm.py:54-80's shape and inputs), with f32
  and bf16 recurrent weights; gradients of all four operands.
- Every ``MaskNet`` arch (num_bins 33 and 32, so both of the stride-2
  conv's SAME pads; hidden 32 and 128; 2 layers), forward and
  ``jax.grad`` against the port's autograd, from the same weights (the
  port's init carried to flax's tree by ``convert``).
- ``quadratic_loss`` with and without a frame mask; three Adam steps of
  ``MaskTrainer`` against the JAX ``MaskTrainer`` from the same converted
  init; the oracle masks of ``enhance.masks``.
- The CUDA dispatch with ``torch.cuda`` mocked: a bidirectional
  ``FastLSTM`` inside the gate reaches kernels 20/21's entries, the
  unidirectional arch does not.
- ``io.flax_msgpack`` against ``flax.serialization`` in both directions,
  byte for byte (the port's tree in flax's creation order: checked on
  the trainer's flax init).

Bars.  f32 as tests/test_pallas_lstm.py: 1e-5 forward, 2e-4 gradients.
With bf16 weights h is rounded before every recurrent product: where two
f32 sums of another order fall on either side of a bf16 rounding boundary
the rounded h differs by one bf16 step (2^-8 relative), so the bf16
forward bar is 2e-4 (seen ~2e-5); dW_h comes back in bf16, whose
rounding of two f32 sums of another order can part by one bf16 step of
the largest entry, so the gradient bar is 4e-3 of the peak (2^-8; seen
2.1e-3).  The MaskNet
archs without a recurrence: 1e-5 forward, 1e-5 of the peak for gradients
(f32 sums in another order); lstm/blstm (the recurrent product in bf16,
as _rec_matmul rounds it, whose per-step gradient JAX rounds to bf16 as
well): 5e-5 forward, 5e-3 of the peak for gradients (seen 1.4e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from setk_tpu.enhance import masks as jmasks
from setk_tpu.models import mask_net as jmn
from setk_tpu.models.trainer import MaskTrainer as JaxTrainer
from setk_tpu.ops.pallas.lstm_seq import lstm_seq_bidir as jax_bidir
from setk_tpu_torch.convert import (mask_net_params_from_numpy,
                                    mask_net_params_to_numpy)
from setk_tpu_torch.enhance import masks as tmasks
from setk_tpu_torch.io import flax_msgpack
from setk_tpu_torch.models import mask_net as tmn
from setk_tpu_torch.models.trainer import MaskTrainer
from setk_tpu_torch.ops.cuda import lstm_seq as ls

T, B, H = 12, 8, 128
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-4}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 4e-3}
RECURRENT = ("lstm", "blstm")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xgf = rng.standard_normal((T, B, 4 * H)).astype(np.float32) * 0.5
    xgb = rng.standard_normal((T, B, 4 * H)).astype(np.float32) * 0.5
    whf = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    whb = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    wf = rng.standard_normal((T, B, H)).astype(np.float32)
    wb = rng.standard_normal((T, B, H)).astype(np.float32)
    return (xgf, xgb, whf, whb), (wf, wb)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lstm_case(request):
    """The JAX kernels in interpret mode, once per weight type: inputs,
    outputs and the gradients of sum(ys_f wf) + sum(ys_b wb)."""
    dtype = request.param
    args, (wf, wb) = _inputs(3)
    jargs = [jnp.asarray(a) for a in args]
    jargs[2:] = [w.astype(dtype) for w in jargs[2:]]

    def loss(*a):
        ysf, ysb = jax_bidir(*a, interpret=True)
        return jnp.sum(ysf * wf) + jnp.sum(ysb * wb)

    ys = jax_bidir(*jargs, interpret=True)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)
    return dtype, args, (wf, wb), [np.asarray(y) for y in ys], [
        np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_args(args, dtype, grad=False):
    out = [torch.tensor(a) for a in args]
    out[2:] = [w.to(getattr(torch, dtype)) for w in out[2:]]
    return [a.requires_grad_(grad) for a in out]


def _peak_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_supported_gate():
    assert ls.lstm_seq_supported(1, 512) and ls.lstm_seq_supported(63, 1024)
    assert ls.lstm_seq_supported(64, 100)        # not the TPU's H % 128
    assert not ls.lstm_seq_supported(0, 512)
    assert not ls.lstm_seq_supported(64, 1025)


def test_plain_forward_matches_pallas_kernel(lstm_case):
    dtype, args, _, ys, _ = lstm_case
    ysf, csf, ysb, csb = ls.lstm_seq_forward_plain(*_torch_args(args, dtype))
    np.testing.assert_allclose(ysf.numpy(), ys[0], atol=FWD_TOL[dtype],
                               rtol=FWD_TOL[dtype])
    np.testing.assert_allclose(ysb.numpy(), ys[1], atol=FWD_TOL[dtype],
                               rtol=FWD_TOL[dtype])
    # the cell states are what the next layer never sees but BPTT reads
    assert torch.isfinite(csf).all() and torch.isfinite(csb).all()


def test_plain_gradients_match_pallas_kernel(lstm_case):
    dtype, args, (wf, wb), _, grads = lstm_case
    targs = _torch_args(args, dtype, grad=True)
    ysf, ysb = ls.lstm_seq_bidir(*targs)
    ((ysf * torch.tensor(wf)).sum() + (ysb * torch.tensor(wb)).sum()
     ).backward()
    for a, want, name in zip(targs, grads, ("dxg_f", "dxg_b", "dwh_f",
                                            "dwh_b")):
        assert a.grad.dtype == a.dtype, name
        err = _peak_err(a.grad.float().numpy(), want)
        assert err < GRAD_TOL[dtype], (name, err)


def test_bidir_backward_is_the_plain_forwards_gradient():
    """f32: kernel 21's chain (through the plain versions) against autograd
    through the plain forward, at tests/test_pallas_lstm.py's 2e-4."""
    args, (wf, wb) = _inputs(5)
    got = _torch_args(args, "float32", grad=True)
    ref = _torch_args(args, "float32", grad=True)
    ysf, ysb = ls.lstm_seq_bidir(*got)
    ((ysf * torch.tensor(wf)).sum() + (ysb * torch.tensor(wb)).sum()
     ).backward()
    rf, _, rb, _ = ls.lstm_seq_forward_plain(*ref)
    ((rf * torch.tensor(wf)).sum() + (rb * torch.tensor(wb)).sum()
     ).backward()
    for a, r in zip(got, ref):
        assert _peak_err(a.grad.numpy(), r.grad.numpy()) < 2e-4
    # kernel 20/21's wrappers on CPU tensors count no launch
    assert ls.lstm_seq_forward.launches == ls.lstm_seq_backward.launches == 0


# ---- MaskNet ----

def _models(arch, f, hidden, seed=0):
    """The JAX model and the port's, with the port's seeded init carried
    to flax's tree by ``mask_net_params_to_numpy``."""
    jm = jmn.make_model(arch=arch, num_bins=f, hidden=hidden, num_layers=2)
    tm = tmn.make_model(arch=arch, num_bins=f, hidden=hidden, num_layers=2)
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    return jm, mask_net_params_to_numpy(tm.state_dict()), tm


@pytest.mark.parametrize("arch", tmn.ARCHS)
@pytest.mark.parametrize("f,hidden", [(33, 32), (32, 128)])
def test_masknet_matches_setk_tpu(arch, f, hidden):
    jm, params, tm = _models(arch, f, hidden)
    rng = np.random.default_rng(f + hidden)
    x = (rng.standard_normal((3, 20, f)) * 2 - 3).astype(np.float32)
    w = rng.standard_normal((3, 20, f)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, x)
        return jnp.sum(out * w), out

    jgrads, want = jax.jit(jax.grad(loss, has_aux=True))(params)
    got = tm(torch.tensor(x))
    (got * torch.tensor(w)).sum().backward()
    fwd_tol, grad_tol = (5e-5, 5e-3) if arch in RECURRENT else (1e-5, 1e-5)
    assert got.shape == (3, 20, f)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=fwd_tol)
    tgrads = mask_net_params_to_numpy(
        {k: p.grad for k, p in tm.named_parameters()})
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(tgrads)]
    assert paths == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_leaves_with_path(jgrads)]
    for path, g, ref in zip(paths, jax.tree_util.tree_leaves(tgrads),
                            jax.tree_util.tree_leaves(jgrads)):
        err = _peak_err(g, np.asarray(ref))
        assert err < grad_tol, (path, err)


@pytest.mark.parametrize("masked", [False, True])
def test_quadratic_loss_matches_setk_tpu(masked):
    rng = np.random.default_rng(7)
    pred, tgt = (rng.random((3, 10, 9)).astype(np.float32) for _ in "ab")
    fm = (rng.random((3, 10)) > 0.4).astype(np.float32) if masked else None
    want = float(jmn.quadratic_loss(pred, tgt, fm))
    got = tmn.quadratic_loss(torch.tensor(pred), torch.tensor(tgt),
                             None if fm is None else torch.tensor(fm))
    assert abs(float(got) - want) <= 1e-7
    if masked:   # an all-padding batch divides by max(0, 1)
        zero = torch.zeros((3, 10))
        assert float(tmn.quadratic_loss(torch.tensor(pred),
                                        torch.tensor(tgt), zero)) == 0.0


@pytest.mark.parametrize("arch", ["dnn", "blstm"])
def test_trainer_adam_steps_match_setk_tpu(arch):
    """Three Adam steps from flax's init, converted: losses within 1e-6;
    parameters within 2e-5 (dnn; seen 4.9e-6) or 1e-4 (blstm; seen 3e-5):
    Adam's update lr m / (sqrt(v) + 1e-8) of a parameter whose gradient is
    near 1e-8 moves by up to lr when that gradient changes in its last
    bits (f32 sums in another order, and for blstm one bf16 step of a
    recurrent gradient)."""
    jt = JaxTrainer(jmn.make_model(arch=arch, num_bins=33, hidden=32,
                                   num_layers=1), lr=1e-3, seed=0)
    pt = MaskTrainer(tmn.make_model(arch=arch, num_bins=33, hidden=32,
                                    num_layers=1), lr=1e-3, seed=0,
                     device="cpu")
    pt.model.load_state_dict(mask_net_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt.params)))
    # the converter gives flax's tree in flax's creation order, so the
    # port's checkpoint of flax's init is flax's, byte for byte
    assert flax_msgpack.dumps({"params": mask_net_params_to_numpy(
        pt.model.state_dict())}) == serialization.to_bytes(
            {"params": jt.params})
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((4, 24, 33)).astype(np.float32)
    targets = (feats > 0).astype(np.float32)
    fm = np.ones((4, 24), np.float32)
    fm[1, 20:] = fm[3, 10:] = 0
    for _ in range(3):
        assert abs(jt.train_batch(feats, targets, fm) -
                   pt.train_batch(feats, targets, fm)) < 1e-6
    tol = 1e-4 if arch == "blstm" else 2e-5
    got = mask_net_params_to_numpy(pt.model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jt.params)):
        assert float(np.abs(a - np.asarray(b)).max()) < tol
    np.testing.assert_allclose(pt.predict(feats).numpy(),
                               np.asarray(jt.predict(feats)), atol=1e-5)


def test_trainer_init_is_seeded_and_refuses_a_mesh():
    a, b, c = (MaskTrainer(tmn.make_model("blstm", 33, 16, 1), seed=s,
                           device="cpu") for s in (4, 4, 5))
    sa, sb, sc = (t.model.state_dict() for t in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["FastLSTM_0.wh_f"], sc["FastLSTM_0.wh_f"])
    wh = sa["FastLSTM_0.wh_f"]             # orthonormal rows, as flax's
    assert torch.allclose(wh @ wh.T, torch.eye(16), atol=1e-5)
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        MaskTrainer(tmn.make_model("dnn", 33, 16, 1), mesh=object(),
                    device="cpu")


# ---- the CUDA dispatch, torch.cuda mocked ----

@pytest.fixture
def mocked_card(monkeypatch):
    """torch.cuda reports a card, ``FastLSTM`` takes CPU tensors for card
    tensors, and kernels 20/21's entries count their calls around their
    plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tmn, "_on_card", lambda x: True)
    counts = {}

    def count(name, fn, wh_arg):
        def wrapped(*args):
            counts[name] = counts.get(name, 0) + 1
            assert args[wh_arg].dtype == torch.bfloat16   # as _rec_matmul
            return fn(*args)
        monkeypatch.setattr(ls, f"lstm_seq_{name}", wrapped)

    count("forward", ls.lstm_seq_forward_plain, 2)
    count("backward", ls.lstm_seq_backward_plain, 8)
    return counts


def test_blstm_reaches_the_kernels_and_lstm_does_not(mocked_card,
                                                    monkeypatch):
    counts = mocked_card
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((2, 9, 17)).astype(np.float32))
    for arch, want in (("blstm", {"forward": 3, "backward": 3}),
                       ("lstm", {})):
        counts.clear()
        model = tmn.make_model(arch, 17, 24, 3)
        model(x).sum().backward()
        assert counts == want, arch
    # on a card tensor the bf16 kernel path gives what the CPU loop gives
    # (both round h to bf16 before each product)
    model = tmn.make_model("blstm", 17, 24, 2)
    with_kernels = model(x)
    monkeypatch.setattr(tmn, "_on_card", lambda x: False)
    np.testing.assert_allclose(with_kernels.detach().numpy(),
                               model(x).detach().numpy(), atol=2e-6)


def test_wide_blstm_refuses_on_the_card(mocked_card):
    """Outside kernels 20/21's gate (H > 1024) a blstm on the card
    raises naming ROADMAP queue 1 item 16 and never runs the loop there;
    the unidirectional arch and the CPU keep their loop."""
    counts = mocked_card
    x = torch.zeros((1, 2, 3))                     # (T, B, F)
    layer = tmn.FastLSTM(3, ls.MAX_HIDDEN + 1, bidirectional=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        layer(x)
    assert counts == {}
    assert tmn.FastLSTM(3, ls.MAX_HIDDEN + 1)(x).shape == (1, 2, 1025)
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        MaskTrainer(tmn.make_model("blstm", 3, ls.MAX_HIDDEN + 1, 1),
                    device="cuda")
    tmn.refuse_on_card("blstm", ls.MAX_HIDDEN, "cuda")
    tmn.refuse_on_card("lstm", 2048, "cuda")
    tmn.refuse_on_card("blstm", 2048, "cpu")


# ---- checkpoints and masks ----

@pytest.mark.parametrize("arch", tmn.ARCHS)
def test_flax_msgpack_matches_flax_serialization(arch):
    """The port's checkpoint bytes are flax's for the same tree, and each
    package reads the other's checkpoint back to the same weights."""
    _, params, tm = _models(arch, 33, 16, seed=4)
    blob = serialization.to_bytes({"params": params})
    assert flax_msgpack.dumps({"params": params}) == blob
    tm2 = tmn.make_model(arch, 33, 16, 2)
    tm2.load_state_dict(mask_net_params_from_numpy(
        flax_msgpack.loads(blob)["params"]))
    assert all(torch.equal(tm.state_dict()[k], v)
               for k, v in tm2.state_dict().items())
    restored = serialization.from_bytes({"params": params}, blob)["params"]
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_flax_msgpack_covers_the_formats_flax_writes():
    """Keys of 1-40 characters (fixstr, str8), arrays of 0 to 70,000 bytes
    (fixext 1/2/4/8/16, ext8/16/32 around the bin8/16/32 payloads), large
    shapes (uint16/uint32 ints), a scalar shape and other dtypes."""
    rng = np.random.default_rng(0)
    tree = {"k" * 40: {"a": np.zeros((0,), np.float32)},
            "scalar": np.full((), 2.5, np.float32),
            "ints": np.arange(12, dtype=np.int32).reshape(3, 4),
            "wide": rng.standard_normal((1, 70000 // 4)).astype(np.float32),
            "f64": rng.standard_normal((300,)),
            "shape": np.zeros((70000, 0), np.float32)}
    for n in range(1, 18):
        tree[f"n{n}"] = np.arange(n, dtype=np.uint8)
    blob = serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == blob
    back = flax_msgpack.loads(blob)
    assert list(back) == list(tree)
    for key, value in tree.items():
        got = back[key]["a"] if key.startswith("k") else back[key]
        want = value["a"] if key.startswith("k") else value
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        flax_msgpack.loads(blob + b"\x00")


@pytest.mark.parametrize("values", [
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32],
    ["x" * 31, "y" * 32, "z" * 300, "u" * 70000, b"", b"w" * 70000],
    [[1, [2, "3"]], list(range(17)), {"a": {"b": 1}},
     {f"k{i}": i for i in range(17)}]])
def test_flax_msgpack_values_match_msgpack(values):
    """The subset's values at every header size (ints of every width, str,
    bin, arrays and maps), as msgpack-python packs them and reads them
    back; what lies outside the subset is refused."""
    import msgpack
    for value in values:
        blob = msgpack.packb(value, use_bin_type=True)
        assert flax_msgpack.dumps(value) == blob, value
        assert flax_msgpack.loads(blob) == value, value
    with pytest.raises(ValueError, match="out of range"):
        flax_msgpack.dumps(-1)
    for outside in (-1, 1.5, None, True):
        if outside != -1:
            with pytest.raises(TypeError, match="cannot pack"):
                flax_msgpack.dumps(outside)
        with pytest.raises(ValueError, match="unsupported type byte"):
            flax_msgpack.loads(msgpack.packb(outside))


@pytest.mark.parametrize("mask", tmasks.MASK_TYPES)
def test_compute_mask_matches_setk_tpu(mask):
    rng = np.random.default_rng(5)
    tgt, mix = ((rng.standard_normal((2, 7, 9)) +
                 1j * rng.standard_normal((2, 7, 9))).astype(np.complex64)
                for _ in "ab")
    want = np.asarray(jmasks.compute_mask(tgt, mix, mask))
    got = tmasks.compute_mask(torch.tensor(tgt), torch.tensor(mix), mask)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)


def test_compressions_match_setk_tpu():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    m = np.linspace(-0.5, 1.5, 401).astype(np.float32)
    for name in ("sigmoid_compress", "tangent_compress"):
        np.testing.assert_allclose(
            getattr(tmasks, name)(torch.tensor(x)).numpy(),
            np.asarray(getattr(jmasks, name)(x)), atol=1e-6, rtol=1e-6)
    for name in ("sigmoid_uncompress", "tangent_uncompress"):
        np.testing.assert_allclose(
            getattr(tmasks, name)(torch.tensor(m)).numpy(),
            np.asarray(getattr(jmasks, name)(m)), atol=1e-5, rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown mask"):
        tmasks.compute_mask(torch.zeros(2, dtype=torch.complex64),
                            torch.zeros(2, dtype=torch.complex64), "x")
