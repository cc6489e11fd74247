"""Plain references of the configurations, one module each."""
