"""``Model.loss``, its aux loss and every gradient against the JAX
package's ``loss`` under ``jax.grad`` for DBRX (16/8-expert MoE at the
cut, 4 experts top-2), Gemma3 (a sliding layer over 81 tokens, past the
cut's 64-token window: the banded path) and InternLM2, at the reduced
cut, float32, on the reference's weights. The check and its tolerances
are ``test_torch_training.py``'s (``check_loss_and_grads``).
"""
import pytest

from test_torch_training import (  # noqa: F401
    check_loss_and_grads, one_cpu_thread, router_margins)

ARCHS = ('dbrx-132b', 'gemma3-4b', 'internlm2-20b')


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_the_reference(arch,
                                                         router_margins):
    check_loss_and_grads(arch, router_margins)
