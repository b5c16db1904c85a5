"""The paper's own benchmark family: the Table-4 MobileNetV1 ladder.

As data, the calibrated latency/accuracy model (``fleet.dynamics``)
reads MACs, dtype and top-5 accuracy of the eight operating points
d0..d7 from here. As a served model, the ladder is a small decoder
transformer (``CONFIG``) scaled by the same width multipliers x {bf16,
int8} (``ladder``); the Table-4 numbers stay as its metadata.
"""
from repro_torch.configs.base import ModelConfig, scale_width

CONFIG = ModelConfig(
    name="edge-ladder", arch_type="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
    d_ff=1024, vocab_size=8192,
    mlp_act="swiglu",
    citation="MobileNetV1 ladder, arXiv:1704.04861 Table 4 of the paper",
)

# Paper Table 4: (name, million MACs, dtype, top1, top5) for d0..d7.
MOBILENET_TABLE4 = (
    ("d0", 569, "fp32", 70.9, 89.9), ("d1", 317, "fp32", 68.4, 88.2),
    ("d2", 150, "fp32", 63.3, 84.9), ("d3", 41,  "fp32", 49.8, 74.2),
    ("d4", 569, "int8", 70.1, 88.9), ("d5", 317, "int8", 66.8, 87.0),
    ("d6", 150, "int8", 60.7, 83.2), ("d7", 41,  "int8", 48.0, 72.8),
)

_WIDTH = {569: 1.0, 317: 0.75, 150: 0.5, 41: 0.25}


def ladder():
    """d0..d7 transformer variant configs mirroring Table 4."""
    return {did: scale_width(CONFIG, _WIDTH[macs],
                             quant="int8" if dt == "int8" else "none")
            for did, macs, dt, _t1, _t5 in MOBILENET_TABLE4}
