"""Host-side core of the launcher: configs, their key registry, file access."""
