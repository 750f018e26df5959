"""Serving layer above the engine (async request orchestration)."""
