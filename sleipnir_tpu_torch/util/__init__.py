"""Diagnostics support: profilers, the diagnostic tables and the sparsity
recorder (port of `sleipnir_tpu/util`)."""
