"""Runtime environment: the device world of N virtual ranks."""
