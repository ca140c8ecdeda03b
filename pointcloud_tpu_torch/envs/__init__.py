"""Scene configuration."""
