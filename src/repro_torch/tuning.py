"""Tuning flags — the port's copy of the flags of ``repro/tuning.py``
that its code reads.

``FLAGS["moe_cf"]`` overrides the MoE capacity factor (0.0 = use the
config's ``capacity_factor``); ``models.moe.moe_block`` reads it at each
call, as the reference does. ``FLAGS["loss_chunk"]`` is the sequence
chunk of ``Model.loss``'s logits and cross-entropy (its default when the
call passes none); ``FLAGS["remat_policy"]`` is what a rematerialised
layer keeps for its backward: ``"full"`` nothing (the layer is recomputed
whole), ``"dots"`` the outputs of its matrix products without batch
dims (``models.transformer.rematerialise``). ``FLAGS["kv_cache_dtype"]``
is the storage of the decode K/V cache that ``Model.cache_spec`` /
``input_specs`` describe: ``"bf16"`` (the model's dtype) or ``"int8"``
(int8 K/V with a float32 symmetric scale a (slot, kv head), ``k_s`` /
``v_s``), which ``models.transformer.layer_decode`` quantizes into and
dequantizes from as the reference does. The reference's other flags
have no reader here: K3 does not chunk its kv sequence in Python
(``attn_chunk``), the decode updates its cache in place, so donating it
would change nothing (``donate_cache``), and K6 scans the whole
sequence (``mamba_chunk``).
"""
FLAGS = {
    # MoE capacity factor override (0.0 = use the config's value)
    "moe_cf": 0.0,
    # training loss: sequence chunk for the logits/CE loop
    "loss_chunk": 512,
    # layer remat policy: "full" (recompute everything) | "dots"
    # (save matmul outputs, recompute elementwise)
    "remat_policy": "full",
    # decode KV cache storage dtype: "bf16" | "int8" (per-slot-head
    # symmetric scales)
    "kv_cache_dtype": "bf16",
}
