"""Batched environments."""
