"""``Model.loss``, its aux loss and every gradient against the JAX
package's ``loss`` under ``jax.grad`` for the state-space
(Falcon-Mamba: K6's plain scan is differentiable on the CPU), hybrid
(Hymba: its sliding layer over 81 tokens, past the cut's 64-token
window, takes the banded path) and encoder-decoder (Whisper: the
encoder over 32 stub frames, each decoder layer's cross-attention onto
it) ids of ``ARCH_IDS``, at the reduced cut, float32, on the reference's
weights. The check and its tolerances are ``test_torch_training.py``'s
(``check_loss_and_grads``).
"""
import pytest

from test_torch_training import (  # noqa: F401
    check_loss_and_grads, one_cpu_thread, router_margins)

ARCHS = ("falcon-mamba-7b", "hymba-1.5b", "whisper-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_the_reference(arch,
                                                         router_margins):
    check_loss_and_grads(arch, router_margins)
