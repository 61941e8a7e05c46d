"""Host-side utilities: scalar metrics logging."""
