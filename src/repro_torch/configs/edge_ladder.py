"""The paper's Table-4 MobileNetV1 ladder as data: the calibrated
latency/accuracy model (``fleet.dynamics``) reads MACs, dtype and top-5
accuracy of the eight operating points d0..d7 from here."""

# Paper Table 4: (name, million MACs, dtype, top1, top5) for d0..d7.
MOBILENET_TABLE4 = (
    ("d0", 569, "fp32", 70.9, 89.9), ("d1", 317, "fp32", 68.4, 88.2),
    ("d2", 150, "fp32", 63.3, 84.9), ("d3", 41,  "fp32", 49.8, 74.2),
    ("d4", 569, "int8", 70.1, 88.9), ("d5", 317, "int8", 66.8, 87.0),
    ("d6", 150, "int8", 60.7, 83.2), ("d7", 41,  "int8", 48.0, 72.8),
)
