"""Label schema and field categories."""
