"""Multi-device serving: the data-parallel sampler."""
