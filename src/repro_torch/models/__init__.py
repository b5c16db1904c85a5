"""The served model of the port: the dense decoder behind the edge-ladder
variants, with its attention and int8 projections on the hand-written
kernels K3-K5."""
from repro_torch.models.model import Model, build_model
