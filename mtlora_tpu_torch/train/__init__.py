"""Losses, optimizer and schedules, and the training step."""
