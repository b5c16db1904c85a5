"""Serving: request batching and the per-(tier, variant) engines."""
from repro_torch.serving.batching import Request, RequestBatcher
from repro_torch.serving.engine import ServingEngine
