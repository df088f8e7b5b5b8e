"""Single-device sweep engine."""
