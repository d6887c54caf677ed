"""Metrics, timing and device-memory helpers."""
