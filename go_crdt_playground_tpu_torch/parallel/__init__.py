"""Gossip schedules and replica-axis reductions."""
