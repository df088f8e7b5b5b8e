"""End-to-end yields pipeline."""
