"""Port of ``models/resnet.py`` (ResNet-20, BASELINE config 3) held to flax
at its published widths (16/32/64, 3 blocks per stage), through
``convert.resnet_state_dict``:

* eval-mode logits of a batch of 2, on 32×32×3 (CIFAR-10) and on a 28×28
  input with no channel dim, within ``rtol=atol=1e-5`` (f32; flax's
  GroupNorm takes the variance as E[x²] − E[x]², torch's in another
  order, and the difference passes through 19 convolutions);
* one step's gradients against ``jax.grad`` of the same cross-entropy,
  within ``rtol=1e-4, atol=1e-5`` (f32 sums in other orders; the 3×3
  convolutions' weight gradients sum over batch × positions).  A ReLU
  input within the two frameworks' rounding difference (~1e-6) of 0 may
  fall on the other side of the kink in each (a batch of 2 holds ~4·10⁵
  ReLU inputs), which moves the gradients upstream of it by ~1e-3.  So
  the port's ReLUs take the masks of flax's forward (recorded from an
  eager ``apply``, and each checked to agree with the port's own sign
  wherever its input is farther than 1e-5 from 0): both sides are
  differentiated on the same linear piece;
* the two silent traps: XLA's ``"SAME"`` pads a stride-2 map (0, 1),
  not (1, 1), and flax's GroupNorm epsilon is 1e-6, not torch's 1e-5.
  Each shows at a size where it is large: the strided convolutions
  against ``lax.conv_general_dilated`` at every map size the model meets,
  and the logits of an input scaled by 1e-3, where the first GroupNorm's
  variance is of the order of the epsilon.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from distributed_tensorflow_tpu.models.resnet import ResNet20 as JaxResNet
from distributed_tensorflow_tpu_torch.engines.base import cross_entropy
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.models.convert import resnet_state_dict
from distributed_tensorflow_tpu_torch.models.resnet import (
    GN_EPS, ResNet20, _same_pad, conv_same)

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

LOGITS = dict(rtol=1e-5, atol=1e-5)
GRADS = dict(rtol=1e-4, atol=1e-5)


def _pair(shape, seed=0):
    """(flax params, port model holding them, input) at full width."""
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    params = JaxResNet().init(jax.random.key(seed), x)["params"]
    model = create_model("resnet20", device="cpu")
    with torch.no_grad():
        model(torch.from_numpy(x[:1]))   # the lazy stem takes its channels
    model.load_state_dict(resnet_state_dict(
        jax.tree.map(np.asarray, params)))
    return params, model, x


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 28, 28)])
def test_resnet_logits_match_flax(shape):
    params, model, x = _pair(shape)
    want = np.asarray(JaxResNet().apply({"params": params}, x))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **LOGITS)


def _flax_relu_masks(params, x, monkeypatch):
    """flax's ReLU masks (input > 0) in call order, NCHW, from an eager
    ``apply``."""
    import flax.linen

    masks, relu = [], flax.linen.relu

    def recorded(v):
        masks.append(torch.from_numpy(np.asarray(v) > 0).permute(0, 3, 1, 2))
        return relu(v)

    monkeypatch.setattr(flax.linen, "relu", recorded)
    JaxResNet().apply({"params": params}, x)
    monkeypatch.undo()
    return masks


def test_resnet_gradients_match_jax(monkeypatch):
    params, model, x = _pair((2, 32, 32, 3), seed=1)
    y = np.array([3, 8], np.int32)

    def loss_fn(p):
        logits = JaxResNet().apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    want = resnet_state_dict(jax.tree.map(np.asarray,
                                          jax.grad(loss_fn)(params)))
    masks = iter(_flax_relu_masks(params, x, monkeypatch))

    def masked_relu(v):
        mask = next(masks)
        far = v.detach().abs() > 1e-5
        assert torch.equal((v.detach() > 0)[far], mask[far])
        return v * mask

    monkeypatch.setattr(torch, "relu", masked_relu)
    logits = model(torch.from_numpy(x))
    monkeypatch.undo()
    assert next(masks, None) is None       # one mask per ReLU
    cross_entropy(logits, torch.from_numpy(y)).mean().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(),
                                   err_msg=name, **GRADS)


def test_resnet_traps_same_pad_and_group_norm_eps():
    """Fails if the stride-2 pad is made symmetric or the GroupNorm
    epsilon goes back to torch's 1e-5."""
    rng = np.random.default_rng(0)
    for size in (32, 16, 28, 14, 7):   # every map a strided conv meets
        x = rng.standard_normal((2, size, size, 8), dtype=np.float32)
        for kernel in (3, 1):
            w = rng.standard_normal((kernel, kernel, 8, 16),
                                    dtype=np.float32)
            want = jax.lax.conv_general_dilated(
                x, w, (2, 2), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            conv = torch.nn.Conv2d(8, 16, kernel, stride=2, bias=False)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
            got = conv_same(torch.from_numpy(x).permute(0, 3, 1, 2), conv,
                            torch.float32).permute(0, 2, 3, 1)
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-4, err_msg=f"{size} {kernel}")
        assert _same_pad(size, 3, 2) == ((0, 1) if size % 2 == 0
                                         else (1, 1))
    assert GN_EPS == 1e-6
    # the first GroupNorm's variance is ~1e-7 here: an epsilon of 1e-5
    # moves the logits by O(1)
    params, model, x = _pair((2, 32, 32, 3))
    x = x * 1e-3
    want = np.asarray(JaxResNet().apply({"params": params}, x))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_resnet_registry_init_and_widths():
    model = create_model("resnet", num_classes=7, device="cpu")
    assert isinstance(model, ResNet20) and len(model.blocks) == 9
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = JaxResNet(num_classes=7).init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32))["params"]
    want = resnet_state_dict(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    n_params = sum(v.numel() for v in got.values())
    assert n_params == sum(v.size for v in jax.tree.leaves(params))
    for name, w in want.items():
        assert got[name].shape == w.shape, name
    # lecun_normal: the stem's 27-wide fan-in gives std 1/sqrt(27)
    for name in ("stem.weight", "blocks.8.conv2.weight"):
        std = got[name].std().item()
        fan_in = np.prod(got[name].shape[1:])
        assert abs(std * np.sqrt(fan_in) - 1) < 0.15, (name, std)
    assert torch.all(got["head.bias"] == 0)
    for name, v in got.items():
        if "norm" in name:   # GroupNorm: scale 1, bias 0
            assert torch.all(v == (1 if name.endswith("weight") else 0)), name
