"""Inference and serving: transforms, scoring, the HTTP service."""
