"""Environment-knob accessors (tpudl_torch.analysis.registry)."""
