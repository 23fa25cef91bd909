"""The repo's example programs on sleipnir_tpu_torch.

Each module states the same problem as its counterpart in `examples/`,
line for line where the DSL allows, with a `device` keyword (the card,
"cuda", by default) that reaches every solve and derivative driver:

    python -m sleipnir_tpu_torch.examples.flywheel_ocp --device cpu
"""
