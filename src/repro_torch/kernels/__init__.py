"""Hand-written Hopper kernels of the fleet loop, their plain PyTorch
versions, and the device-dispatching ops (``kernels.ops``)."""
