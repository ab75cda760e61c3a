"""Scheduler actions: the shared state of the what-if engine's lanes."""
