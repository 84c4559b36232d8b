"""Trainable batch norm in the port (BN and the SyncBN names) held against
the JAX package on the CPU.

* The module: ``NaiveSyncBatchNorm`` against the JAX package's on the same
  NCHW / NHWC input, with a padded (zero) region, in both modes: with
  batch statistics (the JAX module with ``batch_stats`` mutable) the output
  and the running statistics after one update within 1e-6 relative in
  float32; with running statistics the output within 1e-6. In bf16 the
  scale and shift are cast to bf16 before the multiply-add on both sides:
  the outputs within one bf16 rounding (3e-2 normwise, the bf16 bound of
  ``tests/test_torch_compute_dtype.py``).
* ``get_norm``'s names, the state dict's keys and the round trip through
  both converters (``variables_to_state_dict`` and the JAX package's
  ``convert_d2_state_dict_to_variables``).
* The mode comes from the call: a model in ``train()`` mode serves with the
  running statistics, and only ``batch_statistics()`` (the train step)
  moves them.
* PreciseBN's arithmetic on one batch norm: the JAX package's
  ``SimpleTrainer.update_precise_bn`` and the port's over the same three
  batches, from the same statistics, within 1e-6 relative.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu.engine.train_loop import TrainState as JaxTrainState
from jtsm_tpu.engine.trainer import SimpleTrainer as JaxSimpleTrainer
from jtsm_tpu.layers.batch_norm import NaiveSyncBatchNorm as JaxBN
from jtsm_tpu.layers.batch_norm import get_norm as jax_get_norm
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.engine.trainer import SimpleTrainer
from jtsm_tpu_torch.layers import (
    FrozenBatchNorm2d,
    GroupNorm32,
    LayerNormCF,
    NaiveSyncBatchNorm,
    batch_statistics,
    get_norm,
)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, as the other port test
    files have: at one a core, PyTorch's pools spin under the parallel
    tier-1 run and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

TOL = 1e-6
TOL_BF16 = 3e-2


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _input(seed=0, n=2, c=8, h=6, w=10):
    """NCHW activations with a channel-dependent offset (E[x^2] - E[x]^2
    then cancels some digits, as a post-ReLU map does) and a padded
    bottom-right region of zeros, as a static image bucket holds."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, w).astype(np.float32) * 2 + rng.uniform(-3, 3, (1, c, 1, 1)).astype(np.float32)
    x[:, :, h - 2:, :] = 0
    x[:, :, :, w - 3:] = 0
    return x


def _jax_bn_variables(c, seed=1):
    rng = np.random.RandomState(seed)
    return {
        "params": {"scale": rng.normal(1, 0.1, c).astype(np.float32),
                   "bias": rng.normal(0, 0.1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2, c).astype(np.float32)},
    }


def _port_bn(variables):
    bn = NaiveSyncBatchNorm(len(variables["params"]["scale"]))
    bn.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in variables_to_state_dict(
        {"params": {"norm": variables["params"]}, "batch_stats": {"norm": variables["batch_stats"]}}).items()
        for k in [k.split(".", 1)[1]]})
    return bn


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax_in_float32(train):
    x = _input()
    variables = _jax_bn_variables(x.shape[1])
    jbn = JaxBN(x.shape[1])
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    if train:
        want, mutated = jbn.apply(variables, xh, mutable=["batch_stats"])
    else:
        want = jbn.apply(variables, xh)
    bn = _port_bn(variables)
    with batch_statistics(train):
        got = bn(torch.from_numpy(x))
    assert _rel(np.asarray(want).transpose(0, 3, 1, 2), got.detach().numpy()) <= TOL
    if train:
        assert _rel(mutated["batch_stats"]["mean"], bn.running_mean.numpy()) <= TOL
        assert _rel(mutated["batch_stats"]["var"], bn.running_var.numpy()) <= TOL
        # the biased variance of everything the tensor holds, padding
        # included, weighed 0.1 against the old value's 0.9
        xd = x.astype(np.float64)
        var = xd.var(axis=(0, 2, 3))
        assert _rel(0.9 * variables["batch_stats"]["var"] + 0.1 * var, bn.running_var.numpy()) <= 1e-5
    else:
        assert np.array_equal(bn.running_mean.numpy(), variables["batch_stats"]["mean"])


def test_batch_norm_gradient_matches_jax():
    """Through the batch statistics: the input's, the scale's and the
    bias's gradients of a weighted sum."""
    x = _input(2)
    variables = _jax_bn_variables(x.shape[1], 3)
    wts = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jbn = JaxBN(x.shape[1])

    def loss(params, xh):
        y, _ = jbn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xh, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(wts.transpose(0, 2, 3, 1)))

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x.transpose(0, 2, 3, 1)))
    bn = _port_bn(variables)
    xt = torch.from_numpy(x).requires_grad_()
    with batch_statistics():
        (bn(xt) * torch.from_numpy(wts)).sum().backward()
    assert _rel(np.asarray(gx).transpose(0, 3, 1, 2), xt.grad.numpy()) <= 1e-5
    assert _rel(gp["scale"], bn.weight.grad.numpy()) <= 1e-5
    assert _rel(gp["bias"], bn.bias.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_bf16_rounds_where_jax_rounds(train):
    """bf16 input: the statistics in float32, ``mul`` and ``add`` cast to
    bf16, the output bf16."""
    x = _input(5)
    variables = _jax_bn_variables(x.shape[1], 6)
    xb = jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16)
    jbn = JaxBN(x.shape[1])
    if train:
        want, mutated = jbn.apply(variables, xb, mutable=["batch_stats"])
    else:
        want = jbn.apply(variables, xb)
    bn = _port_bn(variables)
    with batch_statistics(train):
        got = bn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    g = got.detach().float().numpy()
    assert np.linalg.norm(w - g) / np.linalg.norm(w) <= TOL_BF16
    # a product rounded to bf16, then the sum rounded: the two sides within
    # two bf16 ulps of each element's magnitude
    assert (np.abs(w - g) <= 2 * 2.0 ** -7 * np.maximum(np.abs(w), 1e-2) + 1e-6).all()
    if train:  # the statistics of the bf16 input in float32
        assert _rel(mutated["batch_stats"]["mean"], bn.running_mean.numpy()) <= TOL
        assert _rel(mutated["batch_stats"]["var"], bn.running_var.numpy()) <= TOL


def test_get_norm_names():
    for name in ("BN", "SyncBN", "nnSyncBN", "naiveSyncBN"):
        assert type(get_norm(name, 8)) is NaiveSyncBatchNorm
        assert type(jax_get_norm(name, 8)) is JaxBN
    assert type(get_norm("FrozenBN", 8)) is FrozenBatchNorm2d
    assert type(get_norm("GN", 8)) is GroupNorm32
    assert type(get_norm("LN", 8)) is LayerNormCF
    assert get_norm("", 8) is None and get_norm(None, 8) is None
    with pytest.raises(KeyError):
        get_norm("BatchNorm", 8)
    assert sorted(get_norm("SyncBN", 8).state_dict()) == ["bias", "running_mean", "running_var", "weight"]
    assert sorted(n for n, _ in get_norm("SyncBN", 8).named_parameters()) == ["bias", "weight"]


def test_layer_norm_matches_jax():
    x = _input(7)
    jln = jax_get_norm("LN", x.shape[1])
    rng = np.random.RandomState(8)
    variables = {"params": {"LayerNorm_0": {"scale": rng.normal(1, 0.1, 8).astype(np.float32),
                                            "bias": rng.normal(0, 0.1, 8).astype(np.float32)}}}
    want = np.asarray(jln.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    ln = LayerNormCF(8)
    ln.load_state_dict({k.split(".", 1)[1]: v for k, v in variables_to_state_dict(
        {"params": {"norm": variables["params"]}}).items()})
    assert _rel(want, ln(torch.from_numpy(x)).detach().numpy()) <= 1e-5


class _JaxConvBN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        from jtsm_tpu.layers import Conv2d

        return Conv2d(8, kernel_size=3, padding=1, use_bias=False, norm="SyncBN", name="conv")(x)


def test_state_dict_round_trip_through_both_converters():
    """The JAX variables -> the port's state dict -> the JAX package's
    ``convert_d2_state_dict_to_variables`` give back the same variables;
    every key is matched."""
    module = _JaxConvBN()
    x = jnp.asarray(_input().transpose(0, 2, 3, 1))
    variables = jax.tree_util.tree_map(np.asarray, module.init(jax.random.key(0), x))
    rng = np.random.RandomState(9)
    variables = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(np.float32), variables)
    state = variables_to_state_dict(variables)
    assert sorted(state) == ["conv.norm.bias", "conv.norm.running_mean", "conv.norm.running_var",
                             "conv.norm.weight", "conv.weight"]
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    back, matched, unmatched = convert_d2_state_dict_to_variables({k: v.numpy() for k, v in state.items()}, template)
    assert not unmatched and len(matched) == 5
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(variables)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb and np.array_equal(a, np.asarray(b)), pa


def test_mode_comes_from_the_call():
    """In ``train()`` mode a batch norm still serves with its running
    statistics and leaves them; under ``batch_statistics()`` it normalises
    with the batch's and moves them once a call."""
    x = torch.from_numpy(_input())
    bn = _port_bn(_jax_bn_variables(8))
    bn.train()
    start = bn.running_mean.clone()
    y_serve = bn(x)
    assert torch.equal(bn.running_mean, start)
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    torch.testing.assert_close(y_serve, x * scale[:, None, None] + (bn.bias - bn.running_mean * scale)[:, None, None])
    with batch_statistics():
        y = bn(x)
        once = bn.running_mean.clone()
        bn(x)
    assert not torch.equal(once, start) and not torch.equal(bn.running_mean, once)
    assert float(y.detach().mean(dim=(0, 2, 3)).sub(bn.bias.detach()).abs().max()) < 1e-5
    with batch_statistics(False):
        bn(x)
    with torch.no_grad():
        assert not any(p.grad is not None for p in bn.parameters())


class _BNOnly(torch.nn.Module):
    compute_dtype = torch.float32

    def __init__(self, bn):
        super().__init__()
        self.bn = bn

    def forward(self, batch, generator=None):
        return {"out": self.bn(torch.as_tensor(batch["x"]))}


class _JaxBNOnly(fnn.Module):
    @fnn.compact
    def __call__(self, batch, train=False):
        return {"out": JaxBN(8, name="bn")(batch["x"])}


def test_update_precise_bn_matches_jax():
    """Three batches through both packages' ``update_precise_bn`` from the
    same statistics: 0.9 * old + 0.1 * (the mean of the three batches'
    statistics), within 1e-6; the loader is read three times."""
    variables = _jax_bn_variables(8, 10)
    batches = [{"x": _input(20 + i)} for i in range(3)]
    fake = types.SimpleNamespace(
        model=_JaxBNOnly(),
        state=JaxTrainState(step=0, params={"bn": variables["params"]}, frozen={},
                            batch_stats={"bn": variables["batch_stats"]}, opt_state=None, rng=jax.random.key(0)),
        _data_loader_iter=iter([{"x": jnp.asarray(b["x"].transpose(0, 2, 3, 1))} for b in batches]))
    JaxSimpleTrainer.update_precise_bn(fake, 3)
    want = fake.state.batch_stats["bn"]
    model = _BNOnly(_port_bn(variables))
    it = iter(batches + [None])
    port = types.SimpleNamespace(model=model, state=types.SimpleNamespace(generator=None), _data_loader_iter=it)
    SimpleTrainer.update_precise_bn(port, 3)
    assert next(it) is None
    assert _rel(want["mean"], model.bn.running_mean.numpy()) <= TOL
    assert _rel(want["var"], model.bn.running_var.numpy()) <= TOL
    xs = np.stack([b["x"].astype(np.float64) for b in batches])
    mean = xs.mean(axis=(1, 3, 4)).mean(axis=0)
    assert _rel(0.9 * variables["batch_stats"]["mean"] + 0.1 * mean, model.bn.running_mean.numpy()) <= 1e-5
