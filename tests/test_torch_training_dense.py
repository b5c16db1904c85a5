"""``Model.loss``, its aux loss and every gradient against the JAX
package's ``loss`` under ``jax.grad`` for Yi, Gemma and PaliGemma (its
loss over the text tokens behind 8 stub image embeddings), at the
reduced cut, float32, on the reference's weights. The check and its
tolerances are ``test_torch_training.py``'s (``check_loss_and_grads``).
"""
import pytest

from test_torch_training import (  # noqa: F401
    check_loss_and_grads, one_cpu_thread, router_margins)

ARCHS = ('yi-34b', 'gemma-7b', 'paligemma-3b')


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_the_reference(arch,
                                                         router_margins):
    check_loss_and_grads(arch, router_margins)
