"""Loss terms and the multi-task criterion."""
