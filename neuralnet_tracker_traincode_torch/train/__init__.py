"""Training step, optimizer and learning-rate schedules."""
