"""Weights and host-side helpers."""
