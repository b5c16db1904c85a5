"""Tuning flags — the port's copy of the one flag of ``repro/tuning.py``
that its code reads.

``FLAGS["moe_cf"]`` overrides the MoE capacity factor (0.0 = use the
config's ``capacity_factor``); ``models.moe.moe_block`` reads it at each
call, as the reference does.
"""
FLAGS = {
    # MoE capacity factor override (0.0 = use the config's value)
    "moe_cf": 0.0,
}
