"""ContextLocNet (``contextlocnet_V_16_DC5_1x.yaml``) and CMIL
(``cmil_V_16_DC5_1x.yaml``) on the narrow VGG16 DC5, whose map trains
(FREEZE_AT 2 stops nothing, ROADMAP §3), against the JAX package as
``tests/test_torch_wsod_zoo.py`` sets out: the gradients within 3e-3 of
each norm, ``tests/test_torch_wsod.py``'s VGG16 tolerance (measured 1.2e-3
and 1.7e-3, in the first convolutions)."""

import pytest

from tests.test_torch_wsod import _jax_dan_without_dropout, _two_torch_threads  # noqa: F401  (the fixtures)
from tests.test_torch_wsod_zoo import check_head_case


@pytest.mark.parametrize("case", ["contextlocnet_vgg", "cmil_vgg"])
def test_vgg_heads_detections_losses_and_gradients_match_jax(case):
    want_losses, tm = check_head_case(case)
    assert tm.backbone.conv1_1.weight.grad.abs().max() > 0  # the map trains
    if case == "cmil_vgg":
        assert sorted(want_losses) == ["loss_mil", "loss_refine_cls0", "loss_refine_cls1"]
