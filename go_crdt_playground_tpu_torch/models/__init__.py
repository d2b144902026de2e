"""Replica state models: batches of CRDT replicas as tensors."""
