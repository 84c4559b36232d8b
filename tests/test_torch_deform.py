"""The deformable convolution of the port (``layers.deform_conv``, the
ResNet's ``DeformBottleneckBlock``) held against the JAX package on the CPU
(``jtsm_tpu/layers/deform_conv.py``, ``modeling/backbone/resnet.py:174-260``).

The offsets are seeded in [-3, 3] px with dy and dx drawn apart, reach past
every edge of the map, and a quarter of them are whole pixels (the corner
weights 0 and 1, and floor's kink); the blocks' ``conv2_offset`` kernels are
seeded (``_random_variables``; in the backbone scaled to offsets of a few
pixels, ``offsets_scaled``), not the zeros the JAX package starts from, so
that the offsets move every tap. A port that ignored the offsets or read
dx for dy fails the first test by orders of magnitude (checked there).

Tolerances (float32 on both sides, JAX matmul precision "highest"; the
largest gap measured on the CPU in brackets):

* ``deform_conv2d``: output within 1e-4 of the JAX output's largest
  magnitude (at most 2.3e-7); gradients with respect to the input, the
  offsets, the mask and the kernel normwise within 1e-4 of JAX's (at most
  1.1e-7);
* bfloat16 (inputs and kernel cast to bf16, offsets, weights and mask in
  float32, the result float32 on both sides): within 2^-7 of the largest
  magnitude (at most 2.4e-7), and at least 10x nearer JAX's bf16 output
  than JAX's float32 one (2.4e-3 away: the port rounds the inputs as JAX
  does);
* the blocks and the narrow dconv ResNet-50 FPN: outputs within 1e-4 of
  the largest magnitude (at most 6.3e-7 and 1.9e-6), every parameter's
  gradient of a seeded linear functional normwise within 1e-4 (at most
  7.8e-7 and 6.5e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.layers import deform_conv2d as jax_deform_conv2d
from jtsm_tpu.modeling import build_backbone as jax_build_backbone
from jtsm_tpu.modeling.backbone.resnet import DeformBottleneckBlock as JaxDeformBlock
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_dconv_cfg
from jtsm_tpu_torch.layers import deform_conv2d
from jtsm_tpu_torch.modeling.backbone import build_backbone
from jtsm_tpu_torch.modeling.backbone.resnet import DeformBottleneckBlock
from tests.test_torch_meta_archs import _random_variables

TOL = 1e-4
BF16_STEP = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(want, got):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / float(np.abs(a).max())


def _normwise(want, got):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _inputs(seed, b=2, h=9, w=11, cin=5, cout=7, k=3):
    """NHWC input, offsets (B, H, W, 2*K*K) in [-3, 3] px with dy and dx
    drawn apart and a quarter of them whole pixels, the (K, K, Cin, Cout)
    kernel, mask logits (B, H, W, K*K)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    off = rng.uniform(-3.0, 3.0, size=(b, h, w, k * k, 2))
    off[..., 1] = rng.uniform(-3.0, 3.0, size=(b, h, w, k * k))  # dx apart from dy
    whole = rng.uniform(size=off.shape) < 0.25
    off = np.where(whole, np.round(off), off).reshape(b, h, w, 2 * k * k).astype(np.float32)
    kernel = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    mask = rng.normal(size=(b, h, w, k * k)).astype(np.float32)
    return x, off, kernel, mask


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _port(x, off, kernel, mask, dilation, dtype=torch.float32, grad=False):
    """The port's deform_conv2d on the NHWC numpy inputs; with ``grad``, the
    gradients of sum(out * cot) too, in the JAX layouts."""
    tx, toff = _nchw(x).requires_grad_(grad), _nchw(off).requires_grad_(grad)
    tk = torch.tensor(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_(grad)
    tm = None if mask is None else _nchw(mask).requires_grad_(grad)
    out = deform_conv2d(tx.to(dtype), toff, tk.to(dtype), None if tm is None else torch.sigmoid(tm),
                        dilation=dilation)
    y = out.permute(0, 2, 3, 1)
    if not grad:
        return y.detach().numpy()
    cot = torch.tensor(np.random.default_rng(9).normal(size=tuple(y.shape)).astype(np.float32))
    (y * cot).sum().backward()
    grads = {"x": tx.grad.permute(0, 2, 3, 1), "offsets": toff.grad.permute(0, 2, 3, 1),
             "kernel": tk.grad.permute(2, 3, 1, 0)}
    if tm is not None:
        grads["mask"] = tm.grad.permute(0, 2, 3, 1)
    return y.detach().numpy(), {k: v.numpy() for k, v in grads.items()}, cot.numpy()


def _jax(x, off, kernel, mask, dilation, dtype=jnp.float32):
    m = None if mask is None else jax.nn.sigmoid(jnp.asarray(mask))
    return jax_deform_conv2d(jnp.asarray(x).astype(dtype), jnp.asarray(off), jnp.asarray(kernel).astype(dtype), m,
                             dilation=dilation)


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv2d_forward_and_gradients_match_jax(dilation, modulated):
    x, off, kernel, mask = _inputs(dilation + 2 * modulated)
    mask = mask if modulated else None
    got, grads, cot = _port(x, off, kernel, mask, dilation, grad=True)

    def f(x_, off_, k_, m_):
        with jax.default_matmul_precision("highest"):
            return jnp.sum(jax_deform_conv2d(x_, off_, k_, None if m_ is None else jax.nn.sigmoid(m_),
                                             dilation=dilation) * cot)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(_jax(x, off, kernel, mask, dilation))
    err = _rel(want, got)
    print("output", err)
    assert err <= TOL
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 2)
    jg = jax.grad(f, argnums=argnums)(jnp.asarray(x), jnp.asarray(off), jnp.asarray(kernel),
                                      None if mask is None else jnp.asarray(mask))
    for name, g in zip(("x", "offsets", "kernel", "mask"), jg):
        err = _normwise(np.asarray(g), grads[name])
        print(name, err)
        assert err <= TOL, name
    # the offsets matter: ignored or with dy and dx swapped the port is far off
    swapped = off.reshape(off.shape[:-1] + (-1, 2))[..., ::-1].reshape(off.shape)
    assert _rel(want, _port(x, np.zeros_like(off), kernel, mask, dilation)) > 1e3 * TOL
    assert _rel(want, _port(x, swapped, kernel, mask, dilation)) > 1e3 * TOL


def test_deform_conv2d_bf16_promotes_as_jax():
    """Under bf16 compute the input and kernel round to bf16 and the
    sampling and the product run in float32, as JAX's type promotion makes
    them: the result is float32 and sits on JAX's bf16 result, far nearer
    than on the float32 one."""
    x, off, kernel, mask = _inputs(7)
    with jax.default_matmul_precision("highest"):
        want16 = _jax(x, off, kernel, mask, 1, jnp.bfloat16)
        want32 = np.asarray(_jax(x, off, kernel, mask, 1))
    assert want16.dtype == jnp.float32
    tx = _nchw(x).to(torch.bfloat16)
    tk = torch.tensor(kernel.transpose(3, 2, 0, 1).copy()).to(torch.bfloat16)
    out = deform_conv2d(tx, _nchw(off), tk, torch.sigmoid(_nchw(mask)))
    assert out.dtype == torch.float32
    got = out.permute(0, 2, 3, 1).numpy()
    err, gap32 = _rel(np.asarray(want16), got), _rel(np.asarray(want16), want32)
    print("bf16", err, "bf16 against float32", gap32)
    assert err <= BF16_STEP and err * 10 <= gap32


def offsets_scaled(variables, factor=0.05):
    """``variables`` with every ``conv2_offset`` kernel times ``factor``: at
    1/sqrt(fan-in) a seeded ResNet's offsets reach 10-50 px on a 12x16 res3
    (measured), and nearly every tap samples off the map; at 0.05 of it
    they are a few pixels, as a trained model's."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * factor if "conv2_offset" in str(path) and "kernel" in str(path) else a, variables)


def _block_pair(seed, x, **kw):
    """The JAX ``DeformBottleneckBlock`` with seeded variables (its
    ``conv2_offset`` kernel included) and the port's block with them."""
    jm = JaxDeformBlock(**kw)
    variables = _random_variables(jm, jnp.asarray(x), seed=seed)
    assert np.abs(variables["params"]["conv2_offset"]["conv"]["kernel"]).max() > 0
    norm = kw.get("norm", "FrozenBN")
    tm = DeformBottleneckBlock(kw["in_channels"], kw["out_channels"], kw["bottleneck_channels"], kw.get("stride", 1),
                               kw.get("num_groups", 1), norm, kw.get("stride_in_1x1", True),
                               deform_modulated=kw.get("deform_modulated", False),
                               deform_num_groups=kw.get("deform_num_groups", 1))
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jm, variables, tm


def _check_block(seed, x, **kw):
    jm, variables, tm = _block_pair(seed, x, **kw)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    tx = _nchw(x)
    out = tm(tx)
    got = out.permute(0, 2, 3, 1).detach().numpy()
    err = _rel(want, got)
    print("block", kw, err)
    assert err <= TOL
    # gradients of a seeded linear functional, every parameter
    cot = np.random.default_rng(seed + 1).normal(size=want.shape).astype(np.float32)
    (out.permute(0, 2, 3, 1) * torch.tensor(cot)).sum().backward()

    def f(params):
        with jax.default_matmul_precision("highest"):
            return jnp.sum(jm.apply({**variables, "params": params}, jnp.asarray(x)) * cot)

    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(f))(variables["params"]))})
    worst = 0.0
    for name, p in tm.named_parameters():
        e = _normwise(want_grads[name].numpy(), p.grad.numpy())
        worst = max(worst, e)
        assert e <= TOL, (name, e)
    print("block gradients", worst)
    return tm, got


@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_deform_block_matches_jax(stride_in_1x1):
    """A strided block (res3's first): the stride on the 1x1, or on the 3x3,
    where the JAX block runs the deformable conv at stride 1 on the
    subsampled map; DCNv1 and FrozenBN."""
    x = np.random.default_rng(3).normal(size=(2, 10, 13, 16)).astype(np.float32)
    tm, got = _check_block(1, x, in_channels=16, out_channels=32, bottleneck_channels=8, stride=2,
                           stride_in_1x1=stride_in_1x1)
    assert got.shape == (2, 5, 7, 32)
    assert tm.conv2_offset.stride == ((1, 1) if stride_in_1x1 else (2, 2))


def test_deform_block_grouped_is_dense_and_modulated():
    """A ResNeXt-shaped block (NUM_GROUPS 4) with DCNv2 and GN: the
    deformable conv2 is dense, one (8, 8, 3, 3) kernel, as the JAX
    package's DeformConv has no groups."""
    x = np.random.default_rng(4).normal(size=(1, 9, 9, 16)).astype(np.float32)
    tm, _ = _check_block(2, x, in_channels=16, out_channels=16, bottleneck_channels=8, num_groups=4, norm="GN",
                         deform_modulated=True)
    assert tuple(tm.conv2.weight.shape) == (8, 8, 3, 3) and tm.conv2.modulated
    assert tm.conv2_offset.out_channels == 27


def test_deform_num_groups_as_jax():
    """DEFORM_NUM_GROUPS 2: under DCNv2 the JAX block reads the first 27 of
    the 54 offset channels (the port too); under DCNv1 its 36 offsets do
    not reshape to 9 taps and it fails, where the port raises at build."""
    x = np.random.default_rng(5).normal(size=(1, 8, 8, 16)).astype(np.float32)
    tm, _ = _check_block(3, x, in_channels=16, out_channels=16, bottleneck_channels=8, deform_modulated=True,
                         deform_num_groups=2)
    assert tm.conv2_offset.out_channels == 54
    jm = JaxDeformBlock(in_channels=16, out_channels=16, bottleneck_channels=8, deform_num_groups=2)
    with pytest.raises(TypeError):
        jm.init(jax.random.key(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="DEFORM_NUM_GROUPS 2 without DEFORM_MODULATED"):
        DeformBottleneckBlock(16, 16, 8, deform_num_groups=2)


def test_narrow_dconv_resnet_fpn_matches_jax():
    """The narrow dconv R50 FPN (``mask_rcnn_R_50_FPN_dconv_cfg(narrow=True)``,
    DCNv1 in res3-res5): p2-p6 and every parameter's gradient of a seeded
    linear functional of them."""
    cfg = mask_rcnn_R_50_FPN_dconv_cfg(narrow=True)
    jc = jax_get_cfg()
    jc.merge_from_other_cfg(cfg)
    x = (np.random.default_rng(6).uniform(size=(1, 96, 128, 3)) * 255 - 120).astype(np.float32)
    jb = jax_build_backbone(jc)
    variables = offsets_scaled(_random_variables(jb, jnp.asarray(x), seed=4))
    tb = build_backbone(cfg)
    assert sum(type(m).__name__ == "DeformBottleneckBlock" for m in tb.modules()) == 13
    tb.load_state_dict(variables_to_state_dict(variables), strict=True)
    with jax.default_matmul_precision("highest"):
        want = jax.tree_util.tree_map(np.asarray, jax.jit(jb.apply)(variables, jnp.asarray(x)))
    got = tb(_nchw(x))
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    rng = np.random.default_rng(7)
    cots = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in want.items()}
    for k in want:
        err = _rel(want[k], got[k].permute(0, 2, 3, 1).detach().numpy())
        print(k, err)
        assert err <= TOL, k
    sum((got[k].permute(0, 2, 3, 1) * torch.tensor(cots[k])).sum() for k in got).backward()

    def f(params):
        with jax.default_matmul_precision("highest"):
            out = jb.apply({**variables, "params": params}, jnp.asarray(x))
            return sum(jnp.sum(out[k] * cots[k]) for k in out)

    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(f))(variables["params"]))})
    worst = 0.0
    for name, p in tb.named_parameters():
        e = _normwise(want_grads[name].numpy(), p.grad.numpy())
        worst = max(worst, e)
        assert e <= TOL, (name, e)
    print("gradients", worst)
