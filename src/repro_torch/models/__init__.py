"""The served models of the port: the decoder families behind the
edge-ladder variants, Falcon-Mamba, Hymba and the mixture-of-experts
Granite, with their attention, int8 projections (the int8 experts too)
and selective scan on the hand-written kernels K3-K6."""
from repro_torch.models.model import Model, build_model
