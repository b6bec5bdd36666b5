"""Training-side planning; only the serve profiles are ported so far."""
