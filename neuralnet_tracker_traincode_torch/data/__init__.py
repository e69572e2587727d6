"""Label schema, field categories, the Batch container and the host-side
sample transforms."""
