"""Framework-free helpers: run metrics and plot dumps."""
