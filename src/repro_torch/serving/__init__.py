"""Serving: request batching, the per-(tier, variant) engines and the
async bridge that drains them concurrently."""
from repro_torch.serving.batching import Request, RequestBatcher
from repro_torch.serving.bridge import BridgeConfig, ServingBridge
from repro_torch.serving.engine import ServingEngine
